"""The port's static-analysis plane (antrea_tpu_torch/analysis/): the suite
over the port, clean with an empty BASELINE.analysis_torch.json; the passes
carried over from the JAX package's plane against the JAX passes on the
same seeded trees; each adapted pass firing on a seeded violation and on a
seeded stale declaration; the five findings the JAX anchors report on the
port, gone through the adaptation; the pass inventory; the CLI; the
baseline discipline; the sync census's attribution (on the CPU: no card,
no sync debug mode)."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import torch_cpu  # noqa: F401  (one torch thread a worker)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import antrea_tpu.analysis as jax_analysis  # noqa: E402
import antrea_tpu_torch.analysis as port_analysis  # noqa: E402
from antrea_tpu_torch.analysis import PASSES, run  # noqa: E402
from antrea_tpu_torch.analysis import caches as port_caches  # noqa: E402
from antrea_tpu_torch.analysis import host_sync  # noqa: E402

PORT = "antrea_tpu_torch"
JAX = "antrea_tpu"

PORT_PASSES = (
    "mesh", "metrics", "phases", "events", "commit-plane", "audit-plane",
    "maintenance", "reshard", "tenant", "thread-safety", "bounded-cache",
    "host-sync", "bounded-buffer", "telemetry-registry", "canonical-shape",
)
CARRIED = ("events", "commit-plane", "audit-plane", "maintenance", "tenant",
           "thread-safety", "bounded-buffer", "canonical-shape")
ADAPTED = ("mesh", "metrics", "phases", "reshard", "bounded-cache",
           "host-sync", "telemetry-registry")

# The five findings the JAX passes report on the port (run over a copy of
# antrea_tpu_torch/ renamed antrea_tpu/): artifacts of JAX-only anchors.
ARTIFACTS = {
    ("mesh", "no-allowlist"),
    ("reshard", "no-sharded-fields"),
    ("metrics", "unreg-src:antrea_tpu_torch"),
    ("telemetry-registry", "unmeasured:chance_bumps"),
    ("telemetry-registry", "unmeasured:dma_hb"),
}


def _cli(*args, root=None):
    cmd = [sys.executable, "-m", "antrea_tpu_torch.analysis", *args]
    if root is not None:
        cmd += ["--root", str(root)]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120)


def _objs(result) -> set:
    return {f.obj for f in result.findings}


# ---------------------------------------------------------------------------
# The suite over the port: ONE invocation (the CLI's --json), clean with
# an empty baseline.
# ---------------------------------------------------------------------------

def test_full_suite_clean_on_head_one_invocation():
    assert tuple(PASSES) == PORT_PASSES
    proc = _cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] is True
    assert tuple(report["passes"]) == PORT_PASSES
    assert report["findings"] == [] and report["errors"] == []
    baseline = json.loads((REPO / "BASELINE.analysis_torch.json").read_text())
    assert baseline["findings"] == {}


def test_list_and_unknown_pass():
    proc = _cli("--list")
    assert proc.returncode == 0, proc.stderr
    listed = [line.split()[0] for line in proc.stdout.splitlines()]
    assert tuple(listed) == PORT_PASSES
    bad = _cli("--pass", "no-such-pass")
    assert bad.returncode == 2 and "no-such-pass" in bad.stderr


def test_inventory_accounts_for_every_jax_pass():
    """Every JAX pass id is carried over, adapted (jit-purity as
    host-sync) or left out (donation-safety), each with its reason in the
    package docstring."""
    doc = port_analysis.__doc__
    rows = {}
    for m in re.finditer(r"^  ([a-z-]+) +(carried over|adapted|left out)"
                         r"(.*?)(?=^  [a-z-]+ {2,}|\Z)", doc, re.M | re.S):
        rows[m.group(1)] = (m.group(2), " ".join(m.group(3).split()))
    assert set(rows) == set(jax_analysis.PASSES)
    for pid in CARRIED:
        assert rows[pid][0] == "carried over", pid
    for pid in ADAPTED:
        if pid != "host-sync":
            assert rows[pid][0] == "adapted" and len(rows[pid][1]) > 20, pid
    assert rows["jit-purity"][0] == "adapted"
    assert rows["jit-purity"][1].startswith("as host-sync")
    assert rows["donation-safety"][0] == "left out"
    assert "in place" in rows["donation-safety"][1]
    assert set(PASSES) == (set(jax_analysis.PASSES)
                           - {"jit-purity", "donation-safety"}
                           | {"host-sync"})
    assert [p for p in PASSES if p != "host-sync"] == [
        p for p in jax_analysis.PASSES
        if p not in ("jit-purity", "donation-safety")]
    assert list(PASSES).index("host-sync") == list(
        jax_analysis.PASSES).index("jit-purity")
    for pid, (_fn, invariant) in PASSES.items():
        assert isinstance(invariant, str) and invariant.strip(), pid


# ---------------------------------------------------------------------------
# Seeded trees.
# ---------------------------------------------------------------------------

def _copy_port(dst: Path, pkg: str = PORT) -> Path:
    """The port's Python sources under dst/<pkg>/ (build outputs and CUDA
    sources left out), plus the repo-root files the passes read."""
    shutil.copytree(REPO / PORT, dst / pkg,
                    ignore=shutil.ignore_patterns(
                        "_build", "csrc", "__pycache__", "*.so", "*.cc"))
    for name in ("README.md", "chip_smoke.py"):
        shutil.copy(REPO / name, dst / name)
    return dst


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return _copy_port(tmp_path_factory.mktemp("port") / "template")


def _tree(template: Path, dst: Path, pkg: str = PORT) -> Path:
    """A copy of the template with its package directory named pkg."""
    shutil.copytree(template, dst)
    if pkg != PORT:
        (dst / PORT).rename(dst / pkg)
    return dst


def _mini_tree(root: Path, pkg: str, files: dict) -> Path:
    for rel, text in files.items():
        p = root / pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return root


def _append(root, pkg, rel, text):
    p = root / pkg / rel
    p.write_text(p.read_text() + text)


def _replace(root, pkg, rel, old, new):
    p = root / pkg / rel
    txt = p.read_text()
    assert old in txt, (rel, old)
    p.write_text(txt.replace(old, new, 1))


# The seeded violations of tests/test_static_analysis.py (copied: that
# module is not imported), each applied to the port's own sources.
def _seed_events(root, pkg):
    _append(root, pkg, "observability/flightrec.py",
            '\n\ndef _seeded_violation(rec):\n'
            '    rec.emit(kind="not-a-declared-kind")\n')


def _seed_commit(root, pkg):
    _append(root, pkg, "datapath/tpuflow.py",
            "\n\ndef install_bundle(self):\n    pass\n")


def _seed_audit(root, pkg):
    _replace(root, pkg, "datapath/audit.py", '"drs": "rule",',
             '"drs": "bogus",')


def _seed_maintenance(root, pkg):
    _append(root, pkg, "datapath/audit.py",
            "\n\ndef _rogue_loop(dp):\n    return dp.canary_scan(0)\n")


def _seed_tenant(root, pkg):
    _append(root, pkg, "datapath/tenancy.py",
            "\n\ndef _rogue_shard(mesh, tuples):\n"
            "    return mesh.shard_of_tuples(tuples)\n")


THREAD_FILES = {
    "agent/apiserver.py": (
        'HANDLER_SAFE = ("good_stats", "tickle")\n\n\n'
        "class AgentApiServer:\n"
        "    def _json_route(self, route, q):\n"
        "        self._dp.good_stats()\n"
        "        return self._dp.evil_poke()\n"
    ),
    "datapath/fake.py": (
        "class FakeDp:\n"
        "    def good_stats(self):\n"
        "        with self._world_ctx(1):\n"
        "            return {}\n\n"
        "    def tickle(self):\n"
        "        self.hits = 1\n"
        "        return 0\n\n"
        "    def unrelated(self):\n"
        "        self.fine = 2\n"
    ),
}

BUFFER_FILES = {
    "dissemination/wild.py": (
        "from collections import deque\n\n"
        'BUFFER_CAPS = {\n'
        '    "W.good_queue": "bounded at max_pending",\n'
        '    "W.ghost_buf": "names a buffer nobody assigns",\n'
        "}\n\n\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self.good_queue = deque()\n"
        "        self.evil_backlog = []\n"
        "        self._rdbuf: bytes = b''\n"
        "        self.count = 0\n"
    ),
    "datapath/elsewhere.py": (
        "class E:\n"
        "    def __init__(self):\n"
        "        self.free_queue = []\n"
    ),
    "parallel/failover.py": (
        "from collections import deque\n\n"
        'BUFFER_CAPS = {\n'
        '    "FailoverPlane.probe_ring": "deque(maxlen=PROBE_RING)",\n'
        "}\n\n\n"
        "class FailoverPlane:\n"
        "    def __init__(self):\n"
        "        self.probe_ring = deque(maxlen=64)\n"
        "        self.sneaky_backlog = []\n"
    ),
}

SHAPE_FILES = {
    "datapath/bad.py": (
        "from .tenancy import _sub_batch\n\n\n"
        "class Dp:\n"
        "    def step_groups(self, tids, batch, now):\n"
        "        for tid in set(tids):\n"
        "            sub = _sub_batch(batch, [0])\n"
        "            self.step(sub, now)\n"
        "        return self.tenant_step(1, _sub_batch(batch, [1]),\n"
        "                                now)\n\n"
        "    def staged(self, batch, now):\n"
        "        t = self.batcher.submit(_sub_batch(batch, [0]), now)\n"
        "        self.batcher.flush_all(now)\n"
        "        return self.step(batch, now)\n"
    ),
}

# pass id -> (seed on a copy of the port, or the files of a mini tree;
# the objs the seed must produce at least).
PARITY = {
    "events": (_seed_events, {"undeclared:not-a-declared-kind"}),
    "commit-plane": (_seed_commit,
                     {"public:datapath/tpuflow.py:install_bundle"}),
    "audit-plane": (_seed_audit, {"bad-class:drs"}),
    "maintenance": (_seed_maintenance,
                    {"rogue:datapath/audit.py:canary_scan"}),
    "tenant": (_seed_tenant,
               {"dropped:shard_of_tuples:datapath/tenancy.py"}),
    "thread-safety": (THREAD_FILES,
                      {"undeclared:evil_poke",
                       "world-ctx:FakeDp.good_stats",
                       "mutates:FakeDp.tickle:hits"}),
    "bounded-buffer": (BUFFER_FILES,
                       {"dissemination/wild.py:W.evil_backlog",
                        "dissemination/wild.py:W._rdbuf",
                        "dissemination/wild.py:W.ghost_buf:stale",
                        "parallel/failover.py:FailoverPlane.sneaky_backlog"}),
    "canonical-shape": (SHAPE_FILES,
                        {"datapath/bad.py:step_groups:step",
                         "datapath/bad.py:step_groups:tenant_step"}),
}


def _mapped(result) -> set:
    """(pass, path, obj) with the JAX package's directory named as the
    port's."""
    def m(s):
        return re.sub(r"(?<![A-Za-z0-9_])antrea_tpu/", f"{PORT}/", s)

    return {(f.pass_id, m(f.path), m(f.obj)) for f in result.findings}


@pytest.mark.parametrize("pass_id", CARRIED)
def test_carried_pass_equals_the_jax_pass(pass_id, template, tmp_path):
    """One seeded tree, once under antrea_tpu_torch/ (the port's pass) and
    once under antrea_tpu/ (the JAX pass): the same findings, paths
    mapped, and the seed's own among them."""
    seed, want = PARITY[pass_id]
    trees = {}
    for pkg in (PORT, JAX):
        if callable(seed):
            root = _tree(template, tmp_path / pkg, pkg)
            seed(root, pkg)
        else:
            root = _mini_tree(tmp_path / pkg, pkg, seed)
        trees[pkg] = root
    port = run(trees[PORT], [pass_id])
    jax = jax_analysis.run(trees[JAX], [pass_id])
    assert _mapped(port) == _mapped(jax)
    assert want <= _objs(port), _objs(port)
    if callable(seed):
        # The port's own tree is clean: the seed is the whole difference.
        assert run(template, [pass_id]).clean


# ---------------------------------------------------------------------------
# The adapted passes: a seeded violation and a seeded stale declaration
# each fire (and the unseeded tree is clean).
# ---------------------------------------------------------------------------

def _seed_metrics_violation(root):
    _append(root, PORT, "observability/flowexport.py",
            '\n_SEEDED = "antrea_tpu_bogus_unregistered_total"\n')
    return {"unreg-src:antrea_tpu_bogus_unregistered_total"}


def _seed_metrics_stale(root):
    (root / "README.md").write_text(
        (root / "README.md").read_text()
        + "\n| `antrea_tpu_ghost_family_total` | counter | gone |\n")
    return {"unreg-readme:antrea_tpu_ghost_family_total"}


def _seed_telemetry_violation(root):
    _append(root, PORT, "models/pipeline.py",
            "\n\ndef _seeded(out, n):\n"
            "    out.update(tel_bogus_counter=n)\n")
    return {"undeclared:bogus_counter"}


def _seed_telemetry_stale(root):
    _replace(root, PORT, "observability/telemetry.py", '    "dma_hb",',
             '    "dma_hb",\n    "ghost_total",')
    return {"unmeasured:ghost_total", "family-unmapped:ghost_total",
            "undocumented:ghost_total"}


def _seed_phases_violation(root):
    _append(root, PORT, "models/pipeline.py", "\nPH_BOGUS_SEEDED = 1 << 29\n")
    return {"ph-all-mismatch"}


def _seed_phases_stale(root):
    # The consumer stops holding its profiles to the chain it imports.
    _replace(root, "", "chip_smoke.py", 'prof.PHASE_CHAIN', 'PHASES_COPY')
    return {"consumer-derive"}


def _seed_mesh_violation(root):
    _replace(root, PORT, "ops/match.py",
             "    bounds6: torch.Tensor  # (NB6, 4) int32, v6 boundaries\n",
             "    bounds6: torch.Tensor  # (NB6, 4) int32, v6 boundaries\n"
             "    seeded_rows: torch.Tensor\n")
    return {"DimTable.seeded_rows"}


def _seed_mesh_stale(root):
    _replace(root, PORT, "parallel/mesh.py", "MESH_REPLICATED = {\n",
             'MESH_REPLICATED = {\n    "DimTable.ghost": "no such field",\n'
             '    "DimTable.inc": "cut, so not replicated",\n')
    return {"stale-replicated:DimTable.ghost", "cut-replicated:DimTable.inc"}


def _seed_mesh_unjoined(root):
    # A field rule_slice cuts that rule_join does not rejoin.
    _replace(root, PORT, "parallel/mesh.py",
             "word_idx=cat(lambda s: getattr(s, d).word_idx))",
             "l7=getattr(shards[0], d).l7)")
    return {"unjoined:DeviceDirection.word_idx"}


def _seed_reshard_violation(root):
    _replace(root, PORT, "models/pipeline.py",
             "class FlowCache(NamedTuple):\n",
             "class FlowCache(NamedTuple):\n"
             "    seeded_col: torch.Tensor\n")
    return {"unmigrated:FlowCache.seeded_col"}


def _seed_reshard_stale(root):
    _replace(root, PORT, "parallel/reshard.py", '"FlowCache.keys"',
             '"BogusCache.keys"')
    return {"stale:BogusCache.keys", "unmigrated:FlowCache.keys"}


def _seed_reshard_world(root):
    _replace(root, PORT, "parallel/meshpath.py", '        "_fo_mask",\n',
             '        "_fo_mask", "_shadow_state",\n')
    _append(root, PORT, "parallel/meshpath.py",
            "\n\ndef _seeded(self, st, mesh):\n"
            "    self._shadow_state = shard_state(st, mesh)\n")
    _replace(root, PORT, "parallel/reshard.py", "WORLD_MIGRATION = {\n",
             'WORLD_MIGRATION = {\n    "_ghost_state": "a field that no '
             'longer exists",\n')
    return {"unmigrated-world:_shadow_state", "stale-world:_ghost_state"}


_CACHE_SRC = (
    "from functools import cache, lru_cache\n\n"
    "import torch\n\n"
    "from .. import _build\n\n\n"
    "@lru_cache(maxsize=None)\n"
    "def lib(name):\n"
    "    return _build.load(name)\n\n\n"
    "@cache\n"
    "def graph(n):\n"
    "    g = torch.cuda.CUDAGraph()\n"
    "    return g\n\n\n"
    "@lru_cache\n"
    "def compiled(fn):\n"
    "    return torch.compile(fn)\n\n\n"
    "@lru_cache(maxsize=8)\n"
    "def bounded(name):\n"
    "    return _build.load(name)\n\n\n"
    "@lru_cache(maxsize=None)\n"
    "def host_data(n):\n"
    "    return list(range(n))\n"
)


def _seed_cache_violation(root):
    (root / PORT / "ops" / "seeded_cache.py").write_text(_CACHE_SRC)
    return {"ops/seeded_cache.py:lib", "ops/seeded_cache.py:graph",
            "ops/seeded_cache.py:compiled"}


def _seed_host_sync_violation(root):
    _append(root, PORT, "ops/match.py",
            "\n\ndef _seeded_sync(t):\n"
            "    return t.sum().item()\n\n\n"
            "class Seeded:\n"
            "    def rows(self, m):\n"
            "        return torch.nonzero(m)\n\n"
            "    def host(self, a):\n"
            "        return np.nonzero(a)\n")
    return {"ops/match.py:_seeded_sync:item",
            "ops/match.py:Seeded.rows:nonzero"}


def _seed_host_sync_stale(root):
    _replace(root, PORT, "ops/match.py", "HOST_SYNCS = {\n",
             'HOST_SYNCS = {\n    "gone_function": "a function that no '
             'longer exists",\n    "tables": "names a function with no '
             'explicit sync",\n    "interval_rows": "implicit: an implicit '
             'row needs no explicit call",\n')
    return {"ops/match.py:gone_function:stale", "ops/match.py:tables:stale"}


ADAPTED_SEEDS = [
    ("metrics", "violation", _seed_metrics_violation),
    ("metrics", "stale", _seed_metrics_stale),
    ("telemetry-registry", "violation", _seed_telemetry_violation),
    ("telemetry-registry", "stale", _seed_telemetry_stale),
    ("phases", "violation", _seed_phases_violation),
    ("phases", "stale", _seed_phases_stale),
    ("mesh", "violation", _seed_mesh_violation),
    ("mesh", "stale", _seed_mesh_stale),
    ("mesh", "unjoined", _seed_mesh_unjoined),
    ("reshard", "violation", _seed_reshard_violation),
    ("reshard", "stale", _seed_reshard_stale),
    ("reshard", "world", _seed_reshard_world),
    ("bounded-cache", "violation", _seed_cache_violation),
    ("host-sync", "violation", _seed_host_sync_violation),
    ("host-sync", "stale", _seed_host_sync_stale),
]


@pytest.mark.parametrize("pass_id,kind,seed", ADAPTED_SEEDS,
                         ids=[f"{p}-{k}" for p, k, _ in ADAPTED_SEEDS])
def test_adapted_pass_fires_on_seeded_drift(pass_id, kind, seed, template,
                                            tmp_path):
    root = _tree(template, tmp_path / "t")
    assert run(root, [pass_id]).clean
    want = seed(root)
    got = _objs(run(root, [pass_id]))
    assert want <= got, got
    if pass_id == "host-sync":
        assert not any("Seeded.host" in o or "interval_rows" in o
                       for o in got), got


def test_bounded_cache_stale_waiver_fires(monkeypatch, tmp_path):
    root = _mini_tree(tmp_path, PORT, {"ops/seeded_cache.py": _CACHE_SRC})
    monkeypatch.setattr(port_caches, "CACHE_ALLOWLIST", {
        "ops/seeded_cache.py:lib": "known, bounded elsewhere",
        "ops/seeded_cache.py:ghost": "waives a cache that is gone"})
    objs = _objs(run(root, ["bounded-cache"]))
    assert "allowlist-stale:ops/seeded_cache.py:ghost" in objs
    assert "ops/seeded_cache.py:lib" not in objs
    assert {"ops/seeded_cache.py:graph",
            "ops/seeded_cache.py:compiled"} <= objs


def test_jax_artifacts_on_the_port_are_gone_through_the_adaptation(
        template, tmp_path):
    """The JAX suite over a copy of the port renamed antrea_tpu/ reports
    the five artifacts of its JAX-only anchors; the port's suite over the
    port reports none of them, with no baseline row."""
    renamed = _tree(template, tmp_path / "renamed", JAX)
    jax = {(f.pass_id, f.obj)
           for f in jax_analysis.run(renamed, ["mesh", "reshard", "metrics",
                                               "telemetry-registry"]).findings}
    assert ARTIFACTS <= jax, jax
    port = run(template, ["mesh", "reshard", "metrics",
                          "telemetry-registry"])
    assert port.clean and not port.suppressed
    assert not ARTIFACTS & {(f.pass_id, f.obj) for f in port.findings}


# ---------------------------------------------------------------------------
# Baseline discipline and the one-pass entry point.
# ---------------------------------------------------------------------------

_SYNC_TREE = {"models/x.py": "def f(t):\n    return t.item()\n"}


def test_baseline_suppresses_by_key_and_fails_when_stale(tmp_path):
    root = _mini_tree(tmp_path, PORT, _SYNC_TREE)
    [finding] = run(root, ["host-sync"]).findings
    assert finding.key == "host-sync:antrea_tpu_torch/models/x.py:models/x.py:f:item"
    (root / "BASELINE.analysis_torch.json").write_text(json.dumps(
        {"findings": {finding.key: "known sync, tracked"}}))
    res = run(root, ["host-sync"])
    assert res.clean and [s.key for s in res.suppressed] == [finding.key]
    # A stale row (nothing fires for it any more) fails the build.
    (root / PORT / "models" / "x.py").write_text("X = 1\n")
    res2 = run(root, ["host-sync"])
    assert not res2.clean
    assert any("stale" in e for e in res2.errors), res2.errors
    # A reasonless row is rejected outright; the JAX baseline file is not
    # the port's.
    (root / "BASELINE.analysis_torch.json").write_text(json.dumps(
        {"findings": {finding.key: ""}}))
    assert any("no reason" in e for e in run(root, ["host-sync"]).errors)
    (root / "BASELINE.analysis_torch.json").unlink()
    (root / "BASELINE.analysis.json").write_text(json.dumps(
        {"findings": {"host-sync:x:y": "the JAX package's file"}}))
    assert run(root, ["host-sync"]).clean


def test_run_cli_runs_one_pass(tmp_path, capsys):
    root = _mini_tree(tmp_path, PORT, _SYNC_TREE)
    assert port_analysis.run_cli("host-sync", ["--root", str(root)]) == 1
    assert "DRIFT[host-sync]" in capsys.readouterr().out
    (root / PORT / "models" / "x.py").write_text(
        'HOST_SYNCS = {"f": "the value sizes a host loop"}\n\n\n'
        "def f(t):\n    return t.item()\n")
    assert port_analysis.run_cli("host-sync", ["--root", str(root)]) == 0
    assert "clean" in capsys.readouterr().out


def test_host_sync_keys_and_matches():
    """The static keys are the census's (a frame's qualified name), and
    the explicit matches are the documented calls."""
    import ast

    assert host_sync.site_key("pipeline_step") == "pipeline_step"
    assert host_sync.site_key("Cls.meth") == "Cls.meth"
    assert host_sync.site_key("make.<locals>.step") == "step"
    assert host_sync.site_key("f.<locals>.C.m") == "C.m"
    src = ("class C:\n"
           "    def m(self, t):\n"
           "        def inner(u):\n"
           "            return u.tolist()\n"
           "        return inner(t), t.cpu(), t.to('cpu'),"
           " t.to(device=torch.device('cpu')), t.to(dev)\n\n\n"
           "def f(t):\n"
           "    torch.cuda.synchronize()\n"
           "    return torch.unique(t), np.unique(t), t.nonzero(),"
           " t.numpy()\n")
    tree = ast.parse(src)
    got = {k: sorted(kind for _l, kind in host_sync.explicit_syncs(fn))
           for k, fn in host_sync.functions(tree)}
    assert got == {"C.m": ["cpu", "to-cpu", "to-cpu"],
                   "inner": ["tolist"],
                   "f": ["nonzero", "numpy", "synchronize", "unique"]}
    declared = host_sync.declared(REPO)
    assert "pipeline_step" in declared["models/pipeline.py"]
    assert all(isinstance(v, dict) for v in declared.values())


# ---------------------------------------------------------------------------
# The sync census's attribution (utils/sync_census.py) on fake frames.
# ---------------------------------------------------------------------------

def _frame(path, qualname, line, back=None):
    name = qualname.rpartition(".")[2]
    code = SimpleNamespace(co_filename=str(path), co_name=name,
                           co_qualname=qualname)
    return SimpleNamespace(f_code=code, f_lineno=line, f_back=back)


def test_sync_census_attributes_to_the_innermost_package_frame():
    from antrea_tpu_torch.utils import sync_census as sc

    pkg = sc.PKG_DIR
    outer = _frame(pkg / "datapath" / "tpuflow.py",
                   "TpuflowDatapath._step", 10)
    step = _frame(pkg / "models" / "pipeline.py", "pipeline_step", 965,
                  outer)
    lam = _frame(pkg / "models" / "pipeline.py",
                 "pipeline_step.<locals>.<lambda>", 970, step)
    torch_frame = _frame("/site-packages/torch/functional.py", "unique", 5,
                         lam)
    assert sc._site(torch_frame) == ("models/pipeline.py", "pipeline_step",
                                     965)
    assert sc._site(_frame("/elsewhere.py", "f", 1)) is None
    census = sc.SyncCensus()
    census.sites.update({("models/pipeline.py", "pipeline_step"): 4,
                         ("models/pipeline.py", "_no_such_row"): 1,
                         ("datapath/tpuflow.py", "TpuflowDatapath._lane"): 7})
    assert census.total == 12
    assert census.held() == {("models/pipeline.py", "pipeline_step"): 4,
                             ("models/pipeline.py", "_no_such_row"): 1}
    assert census.undeclared() == {("models/pipeline.py", "_no_such_row"): 1}
