"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), nor the repo's JAX benchmarks and smoke script; the reference
loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "flowbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "antrea_tpu"}
NOT_READ = {"bench", "bench_profile", "bench_controller", "chip_smoke"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax_and_reference_no_program():
    for f in PKG.rglob("*.py"):
        if "tests" in f.relative_to(PKG).parts:
            continue
        tops = _imports(f)
        assert not tops & (FORBIDDEN | NOT_READ), f
        if "reference" in f.relative_to(PKG).parts:
            assert "antrea_tpu_torch" not in tops, f
        text = f.read_text()
        for name in NOT_READ:
            assert f"{name}.py\")" not in text and f"'{name}.py'" not in text


_RUN = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import SMALL_MIX, small_config
from flowbench import harness
rec = harness.run_cell(small_config(), SMALL_MIX, 3, 1.0, {trace}, "cpu",
                       time.perf_counter())
chk = harness.compare(rec, "cpu")
spec = harness.cell_spec(harness.load_bench(harness.HERE.parent),
                         "one_ns_10k.conn_churn", harness.HERE.parent)
line = harness.result_line(rec, spec, {trace}, "cpu", 1, chk)
print(json.dumps(dict(mods=sorted({{m.split(".")[0] for m in sys.modules}}),
                      correct=line["correct"])))
"""


def test_a_run_loads_no_jax():
    for trace in (False, True):
        r = subprocess.run(
            [sys.executable, "-c", _RUN.format(root=str(ROOT),
                                               tests=str(PKG / "tests"),
                                               trace=trace)],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["correct"]
        assert not set(out["mods"]) & FORBIDDEN, out["mods"]
        assert "antrea_tpu_torch" in out["mods"]


_REF = """
import json, sys
sys.path.insert(0, {root!r})
from flowbench.reference.datapath import Replay
import numpy as np
plain = {{
  "policy": {{"address_groups": {{"ag": {{"ips": ["10.0.1.2"], "blocks": []}}}},
              "applied_to_groups": {{"at": ["10.0.0.2"]}},
              "policies": [{{"uid": "p", "k8s": False, "tier": 250,
                 "priority": 1.0, "policy_types": [], "applied_to": ["at"],
                 "rules": [{{"direction": "In", "action": "Drop",
                   "priority": 0, "applied_to": [],
                   "peer": {{"groups": ["ag"], "blocks": [],
                            "to_services": 0}},
                   "services": [], "l7": 0}}]}}]}},
  "services": [],
  "topology": {{"local_pods": [["10.0.0.2", 3]], "remote_nodes":
               [["10.0.1.0/24", "192.168.0.1"]], "pod_cidr": "10.0.0.0/24",
               "extra": 0}},
  "engine": {{"flow_slots": 64, "aff_slots": 8, "ct_timeout_s": 3600}}}}
r = Replay(plain, "cpu")
ip = lambda s: int.from_bytes(bytes(map(int, s.split("."))), "big")
cols = {{"src_ip": np.array([ip("10.0.1.2"), ip("10.0.1.3")], np.uint32),
        "dst_ip": np.array([ip("10.0.0.2")] * 2, np.uint32),
        "proto": np.array([6, 6], np.int32),
        "src_port": np.array([1000, 1001], np.int32),
        "dst_port": np.array([80, 80], np.int32),
        "in_port": np.array([1, 1], np.int32)}}
o = r.step(r.lanes(cols), 100)
print(json.dumps(dict(mods=sorted({{m.split(".")[0] for m in sys.modules}}),
                      code=o["code"].tolist(), rule=o["ingress_rule"].tolist(),
                      kind=o["fwd_kind"].tolist(), port=o["out_port"].tolist(),
                      ids=r.cls.ids)))
"""


def test_reference_runs_without_the_program():
    r = subprocess.run([sys.executable, "-c", _REF.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert not set(out["mods"]) & (FORBIDDEN | {"antrea_tpu_torch"})
    # 10.0.1.2 is in the Drop rule's peer group; 10.0.1.3 is not.
    assert out["code"] == [1, 0] and out["ids"] == ["p/In/0"]
    assert out["rule"] == [0, -1]
    assert out["kind"] == [0, 0] and out["port"] == [-1, 3]
