"""The harness finds every configuration, mix and metric by the names in
BENCHMARK.json, and a new cell, configuration, mix or metric takes new
files and new entries only."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import SVC_MIX, service_config, small_config
from flowbench import harness
from flowbench.reference.datapath import Replay
from flowbench.world import build_world, plain_world

ROOT = Path(__file__).resolve().parents[2]


def test_every_entry_resolves():
    bench = harness.load_bench(ROOT)
    assert bench["paths"] == ["flowbench"]
    for cell in bench["workloads"]:
        spec = harness.cell_spec(bench, cell["name"], ROOT)
        assert spec["config"]["engine"]["flow_slots"] > 0
        assert spec["mix"]["batch"] > spec["mix"]["new_per_step"]
        assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) > 1
        assert spec["per_layer"]
        for name in spec["end_to_end"] + spec["per_layer"]:
            assert callable(harness.reader(name))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("flowbench/")
        cfg = harness.load_config(ROOT / c["file"])
        assert (ROOT / "flowbench/worlds" / f"{cfg['world']}.py").is_file()


# Files added by the test below: a configuration of another world shape
# (its own module under flowbench/worlds/), a mix of other classes and
# parameters (data only), and a metric.
_WORLD = """
from flowbench.worlds import np_scale_test


def build(config):
    # np_scale_test's world with the agent on the last node.
    cfg = dict(config, cluster=dict(config["cluster"],
                                    node=config["cluster"]["nodes"] - 1))
    return np_scale_test.build(cfg)
"""
_FLOOD = {"batch": 512, "new_per_step": 256, "life_steps": 2,
          "templates": 4, "reply_share": 0.5,
          "classes": [{"name": "flood", "kind": "external_in", "share": 1,
                       "replies": False, "sources": 4}],
          "ports": [[6, 80]], "now_start": 100, "now_step": 1,
          "warm_steps": 2}


def test_adding_a_cell_takes_new_files_only(tmp_path):
    """A copy of the benchmark grows a configuration of a new world shape,
    a mix, a metric and a cell by new files and new entries; every file
    already there is byte for byte the same, and the harness runs the new
    cell's parts end to end on the CPU, correct against the reference."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "flowbench", root / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "flowbench").rglob("*")
              if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = small_config()
    cfg["world"] = "last_node"
    (root / "flowbench/worlds/last_node.py").write_text(_WORLD)
    (root / "flowbench/configs/last_node.json").write_text(json.dumps(cfg))
    (root / "flowbench/traffic/flood.json").write_text(json.dumps(_FLOOD))
    (root / "flowbench/metrics/hot_steps.py").write_text(
        "def read(rec):\n    return rec['steps'] - 1\n")
    bench["configs"].append({"name": "last_node", "source": "x",
                             "file": "flowbench/configs/last_node.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "last_node.flood",
                               "config": "last_node", "traffic": "flood",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "hot_steps", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter", "layer": "Device",
                               "moves": "pkts_per_s",
                               "workloads": ["last_node.flood"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time; from pathlib import Path; sys.path.insert(0, '.');"
        f"sys.path.append({str(ROOT)!r});"
        "from flowbench import harness;"
        "b = harness.load_bench(Path('.'));"
        "s = harness.cell_spec(b, 'last_node.flood', Path('.'));"
        "assert s['mix']['classes'][0]['sources'] == 4;"
        "assert 'hot_steps' in s['per_layer'];"
        "rec = harness.run_cell(s['config'], s['mix'], 5, 0.3, False, 'cpu',"
        " time.perf_counter());"
        "assert rec['plain']['topology']['local_pods'][0][0].startswith("
        "'10.0.23.');"
        "c = harness.compare(rec, 'cpu');"
        "line = harness.result_line(rec, s, True, 'cpu', 1, c);"
        "assert line['correct'] and line['metrics']['hot_steps']['value'] "
        "== rec['steps'] - 1, line;"
        "assert c['allowed'] == 0 and c['replies'] == 0, c;"
        "o = harness.cell_spec(b, b['workloads'][0]['name'], Path('.'));"
        "assert 'hot_steps' not in o['per_layer'];"
        "assert harness.HERE == Path('flowbench').resolve()")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    after = {p: p.read_bytes() for p in (root / "flowbench").rglob("*")
             if p.is_file() and p in before}
    assert after == before


def test_adding_a_service_cell_takes_new_files_only(tmp_path):
    """A copy of the benchmark grows a world of ClusterIP Services, its
    configuration, a mix with a service class and a cell by new files and
    new entries; every file already there is byte for byte the same, and
    the new cell runs end to end on the CPU, correct against the
    reference, its Service replies hitting the reply entries their first
    packets left."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "flowbench", root / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "flowbench").rglob("*")
              if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "flowbench/tests/service_world.py",
                root / "flowbench/worlds/proxied.py")
    cfg = service_config()
    cfg["world"] = "proxied"
    (root / "flowbench/configs/proxied.json").write_text(json.dumps(cfg))
    (root / "flowbench/traffic/to_services.json").write_text(
        json.dumps(SVC_MIX))
    bench["configs"].append({"name": "proxied", "source": "x",
                             "file": "flowbench/configs/proxied.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "proxied.to_services",
                               "config": "proxied", "traffic": "to_services",
                               "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time; from pathlib import Path; sys.path.insert(0, '.');"
        f"sys.path.append({str(ROOT)!r});"
        "from flowbench import harness;"
        "b = harness.load_bench(Path('.'));"
        "s = harness.cell_spec(b, 'proxied.to_services', Path('.'));"
        "rec = harness.run_cell(s['config'], s['mix'], 2**31 + 3, 0.5, False,"
        " 'cpu', time.perf_counter());"
        "assert len(rec['plain']['services']) == 40;"
        "c = harness.compare(rec, 'cpu');"
        "line = harness.result_line(rec, s, False, 'cpu', 1, c);"
        "assert line['correct'], line;"
        "o = [r for t, r in sorted(rec['checked'].items())];"
        "rep = sum(int(((r.svc_idx >= 0) & (r.reply == 1)).sum()) for r in o);"
        "assert rep > 0, c;"
        "assert harness.HERE == Path('flowbench').resolve()")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    after = {p: p.read_bytes() for p in (root / "flowbench").rglob("*")
             if p.is_file() and p in before}
    assert after == before


def test_engine_options_pass_whole_and_unknown_ones_fail():
    """Every key of a configuration's `engine` reaches the engine: one it
    does not take fails the run, and one the reference does not model
    fails the check, rather than either being left out."""
    w = build_world(small_config())
    w.config["engine"]["no_such_option"] = 1
    with pytest.raises(TypeError):
        harness.build_engine(w, "cpu")
    cfg = small_config()
    cfg["engine"]["async_slowpath"] = True
    w = build_world(cfg)
    eng = harness.build_engine(w, "cpu")
    assert eng._async
    with pytest.raises(NotImplementedError, match="async_slowpath"):
        Replay(plain_world(w), "cpu")


def test_no_card_no_result(tmp_path):
    """Without the CUDA card a cell asks for, the command exits non-zero
    and prints nothing on standard output."""
    r = subprocess.run(
        [sys.executable, "-m", "flowbench.run", "--workload", "one_ns_10k.conn_churn",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert r.returncode != 0 and r.stdout == ""


def test_alone_the_benchmark_gives_no_result(tmp_path):
    """In a directory with BENCHMARK.json and flowbench/ alone (no
    program), the command exits non-zero with no result."""
    shutil.copytree(ROOT / "flowbench", tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = subprocess.run(
        [sys.executable, "-m", "flowbench.run", "--workload", "one_ns_10k.conn_churn",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path)})
    assert r.returncode != 0 and r.stdout == ""
