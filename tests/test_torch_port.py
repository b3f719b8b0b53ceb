"""Package boundary of the PyTorch port: it imports neither jax nor the JAX
package, its entry points default to the card, and every knob it has not
ported refuses instead of taking another path."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antrea_tpu.models import pipeline as jpl
from antrea_tpu.ops import match as jm
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.compiler.compile import compile_policy_set
from antrea_tpu_torch.compiler.services import compile_services
from antrea_tpu_torch.models import forwarding as tfw
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.simulator import gen_cluster, gen_services
import torch_cpu  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import antrea_tpu_torch
names = [m.name for m in pkgutil.walk_packages(antrea_tpu_torch.__path__,
                                               "antrea_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "antrea_tpu" or n.startswith("antrea_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "antrea_tpu"))


def test_import_loads_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert "antrea_tpu_torch.models.pipeline" in res["modules"]
    assert "antrea_tpu_torch.models.profile" in res["modules"]
    for mod in ("consumer", "pruned_consumer", "onepass", "consumer2"):
        assert f"antrea_tpu_torch.ops.{mod}" in res["modules"]
    for mod in (_SLICE_MODULES + _ENGINE_MODULES + _SERVING_MODULES
                + _AGENT_MODULES + _FLEET_MODULES):
        assert mod in res["modules"]
    assert res["bad"] == []


# Tenancy's serving plane, the native store and the scalar twin (with its
# numpy hashes), each loaded alone and by the whole-package import.
_SERVING_MODULES = tuple(f"antrea_tpu_torch.{m}" for m in (
    "serving", "serving.batcher", "native", "native.store",
    "oracle.pipeline", "oracle.hashing", "datapath.oracle_dp"))

_SLICE_MODULES = ("antrea_tpu_torch.parallel", "antrea_tpu_torch.parallel.mesh",
                  "antrea_tpu_torch.parallel.meshpath",
                  "antrea_tpu_torch.models.forwarding",
                  "antrea_tpu_torch.compiler.topology",
                  # The engine's package imports every plane it mixes in
                  # (interface, commit, audit, maintenance, persist,
                  # tenancy, slowpath) and what they pull in.
                  "antrea_tpu_torch.datapath",
                  "antrea_tpu_torch.observability",
                  "antrea_tpu_torch.oracle",
                  "antrea_tpu_torch.controller",
                  "antrea_tpu_torch.dissemination.faults")

# The engine slice's modules, each loaded by the whole-package import.
_ENGINE_MODULES = tuple(f"antrea_tpu_torch.{m}" for m in (
    "datapath.tpuflow", "datapath.interface", "datapath.commit",
    "datapath.audit", "datapath.maintenance", "datapath.persist",
    "datapath.tenancy", "datapath.slowpath", "datapath.slowpath.engine",
    "datapath.slowpath.queue", "observability.metrics",
    "observability.flightrec", "observability.telemetry",
    "observability.tracing", "observability.flowexport", "oracle.interpreter",
    "controller.networkpolicy", "controller.admission",
    "controller.grouping", "dissemination", "dissemination.serde",
    "apis.crd", "config", "features"))

# The agent slice's modules: the agent, the dissemination wire and the
# live surfaces, each a copy of the JAX package's module of the same path.
_AGENT_MODULES = tuple(f"antrea_tpu_torch.{m}" for m in (
    "dissemination.store", "dissemination.netwire", "dissemination.transport",
    "dissemination.agent_proc", "agent", "agent.controller",
    "agent.noderoute", "agent.fqdn", "agent.packetcapture",
    "agent.apiserver", "controller.traceflow", "controller.endpoint_querier",
    "observability.agentinfo", "observability.supportbundle", "antctl"))

# The fleet slice's modules: the fleet simulator, the controller's status
# plane and API, the node agent's host programs, multi-cluster, each a copy
# of the JAX package's module of the same path.
_FLEET_MODULES = tuple(f"antrea_tpu_torch.{m}" for m in (
    "simulator.fleet", "controller.status", "controller.apiserver",
    "controller.certificates", "controller.egress",
    "controller.externalippool", "controller.externalnode",
    "controller.serviceexternalip", "controller.stats",
    "observability.audit", "agent.packetin", "agent.multicast",
    "agent.nodeportlocal", "agent.cni", "agent.secondarynetwork",
    "agent.memberlist", "agent.bgp", "agent.bgp_wire", "agent.gossip",
    "agent.ipassigner", "agent.ipsec", "agent.monitortool", "agent.route",
    "agent.wireguard", "multicluster", "multicluster.core",
    "multicluster.gateway", "clusteridentity"))

# The static-analysis plane and the sync census: stdlib-only (the census
# imports torch when it starts, never at import).
_ANALYSIS_MODULES = tuple(f"antrea_tpu_torch.{m}" for m in (
    "analysis", "analysis.core", "analysis.__main__", "analysis.host_sync",
    "analysis.mesh", "analysis.metrics", "analysis.phases",
    "analysis.reshard", "analysis.caches", "analysis.telemetry",
    "analysis.threads", "analysis.bounded_buffer", "analysis.tenant",
    "analysis.maintenance", "analysis.commit_plane", "analysis.audit_plane",
    "analysis.events", "analysis.canonical_shape", "utils.sync_census"))

_IMPORT_ONE = """
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(n for n in sys.modules
                        if n == "jax" or n.startswith("jax.")
                        or n == "antrea_tpu" or n.startswith("antrea_tpu."))))
"""


@pytest.mark.parametrize("module", _SLICE_MODULES + _SERVING_MODULES + (
    # The agent slice's entry points: the CLI, the child agent process and
    # the package that holds the agent.
    "antrea_tpu_torch.antctl", "antrea_tpu_torch.dissemination.agent_proc",
    "antrea_tpu_torch.agent") + _FLEET_MODULES + _ANALYSIS_MODULES)
def test_module_alone_loads_neither_jax_nor_the_jax_package(module):
    r = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_analysis_import_loads_no_torch():
    """The analysis plane runs on images without torch: importing it (and
    the sync census module) loads neither torch nor numpy."""
    code = ("import sys, json; import antrea_tpu_torch.analysis, "
            "antrea_tpu_torch.analysis.__main__, "
            "antrea_tpu_torch.utils.sync_census; "
            "print(json.dumps(sorted(n for n in sys.modules if n.split('.')[0]"
            " in ('torch', 'numpy', 'jax', 'antrea_tpu'))))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "antrea_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
              ROOT / "chip_step_spans.py",
              ROOT / "chip_b3_variants.py", ROOT / "bench_cold_study_torch.py",
              ROOT / "graft_entry_torch.py",
              ROOT / "tests" / "torch_mesh_ranks.py",
              ROOT / "tests" / "torch_fleet_world.py"]
    assert {"mesh.py", "forwarding.py", "topology.py"} <= {f.name
                                                          for f in files}
    rel = {str(f.relative_to(ROOT)) for f in files}
    for sub in ("datapath", "observability", "oracle", "controller",
                "dissemination", "serving", "native"):
        assert any(r.startswith(f"antrea_tpu_torch/{sub}/") for r in rel), sub
    for mod in _SERVING_MODULES + _AGENT_MODULES + _FLEET_MODULES:
        path = mod.replace(".", "/")
        assert f"{path}.py" in rel or f"{path}/__init__.py" in rel, mod
    seen = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            seen += [(f.name, n) for n in names if _forbidden(n)]
    assert len(files) > 20
    assert seen == []


@pytest.fixture(scope="module")
def tiny():
    cluster = gen_cluster(40, n_nodes=2, pods_per_node=4, seed=1)
    services = gen_services(4, cluster.pod_ips, seed=1)
    return compile_policy_set(cluster.ps), compile_services(services)


def test_entry_points_default_to_the_card(tiny, monkeypatch):
    cps, svc = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_pipeline(cps, svc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_pipeline(cps, svc, dual_stack=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.init_state(16, 16, key_words=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.make_classifier(cps)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.init_state(16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfw.fwd_to_device(ttopo.compile_topology(ttopo.Topology()))
    # The engine's new entry points: the batcher and a persist dir (the
    # device is resolved before the dir is touched).
    from antrea_tpu_torch import datapath as td

    for knob in ({"serving_batcher": True},
                 {"persist_dir": str(ROOT / "never-written")}):
        with pytest.raises(RuntimeError, match="CUDA"):
            td.TpuflowDatapath(**knob)
        with pytest.raises(RuntimeError, match="CUDA"):
            td.make_datapath("tpuflow", **knob)
    assert not (ROOT / "never-written").exists()
    step, state, (drs, _) = tpl.make_pipeline(cps, svc, flow_slots=16,
                                              aff_slots=16, device="cpu")
    assert state.flow.keys.device.type == "cpu"
    assert drs.ingress.at.inc.device.type == "cpu"


def test_mesh_engine_and_graft_entry_default_to_the_card(monkeypatch):
    """The mesh engine, its in-process mesh and the driver entry script
    resolve the card unless the caller passes device="cpu"; on the CPU the
    entry step runs and the dry run steps a (2, 2) mesh engine."""
    import graft_entry_torch as g
    from antrea_tpu_torch import parallel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.MeshDatapath()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.MeshDatapath(n_data=1, n_rule=2, async_slowpath=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.local_mesh(2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        g.entry()
    # The resize and failover entry points: a failover engine, a target
    # mesh on other logical devices.
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.MeshDatapath(failover=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.local_mesh(2, 2, devices=[4, 5, 6, 7])
    mdp = parallel.MeshDatapath(n_data=2, n_rule=2, device="cpu",
                                flow_slots=16, aff_slots=16)
    assert mdp._mesh == parallel.LocalMesh(2, 2, torch.device("cpu"))
    assert mdp._state[1][1].flow.keys.device.type == "cpu"
    # A resize builds its target on the engine's device, never the card's
    # default; the failover plane steps on it too.
    mdp.reshard_begin(4, devices=list(range(8)))
    assert mdp._reshard.t_mesh == parallel.LocalMesh(4, 2,
                                                     torch.device("cpu"))
    mdp.reshard_abort("pinned")
    fo = parallel.MeshDatapath(n_data=2, device="cpu", flow_slots=16,
                               aff_slots=16, failover=True)
    assert fo.failover_stats()["enabled"] == 1
    assert fo._mesh.device.type == "cpu"
    fn, args = g.entry(device="cpu")
    _state, out = fn(*args)
    assert out["code"].shape == (256,) and int(out["n_miss"]) > 0
    g.dryrun_multichip(4)


@pytest.mark.parametrize("knob", [
    {"dual_stack": True}, {"dual_stack": True, "fused": True},
    {"dual_stack": True, "fused": True, "prune_budget": 2}])
def test_dual_stack_pipeline_constructs_and_steps(tiny, knob):
    """dual_stack was refused until queue A item 5: it builds the wide
    state on the CPU, keeps the staged rounds under fused + prune_budget,
    and its step and full walk run v6 lanes (tests/test_torch_dual_stack.py
    holds them to the JAX step)."""
    cps, svc = tiny
    step, state, (drs, dsvc) = tpl.make_pipeline(
        cps, svc, flow_slots=16, aff_slots=16, device="cpu", **knob)
    assert step.meta.key_words == 10 and not step.meta.onepass
    assert state.flow.keys.shape == (17, 10)
    assert state.flow.meta.shape == (17, 8)
    assert state.aff.key_client.shape == (17, 4)
    lanes = [torch.arange(4, dtype=torch.int32)] * 5
    v6 = (torch.arange(16, dtype=torch.int32).reshape(4, 4),) * 2 + (
        torch.tensor([0, 1, 0, 1], dtype=torch.int32),)
    state, out = step(state, drs, dsvc, *lanes, 1, 0, v6=v6)
    assert out["dnat_w_f"].shape == (4, 4) and int(out["n_miss"]) == 4


@pytest.mark.parametrize("knob", [
    {"count_flow_stats": True},
    # The one-pass step's second-chance and telemetry branches.
    {"prune_budget": 4, "fused": True, "second_chance": True},
    {"second_chance": True},
    {"prune_budget": 4, "onepass": True, "telemetry": True},
    {"telemetry": True},
])
def test_ported_pipeline_knobs_step(tiny, knob):
    """The step knobs refused until queue A item 4: each builds a step
    whose meta carries it, and the step and the full walk (with lens) run;
    tests/test_torch_knobs.py holds them to the JAX step."""
    cps, svc = tiny
    step, state, (drs, dsvc) = tpl.make_pipeline(
        cps, svc, flow_slots=16, aff_slots=16, device="cpu", **knob)
    for k in ("count_flow_stats", "second_chance", "telemetry"):
        assert getattr(step.meta, k) == knob.get(k, False)
    lanes = [torch.arange(4, dtype=torch.int32)] * 5
    lens = torch.full((4,), 100, dtype=torch.int32)
    state, out = step(state, drs, dsvc, *lanes, 1, 0, lens=lens)
    assert ("tel_probe_hit" in out) == bool(knob.get("telemetry"))
    dft = tfw.fwd_to_device(ttopo.compile_topology(ttopo.Topology()), "cpu")
    state, out = tfw.pipeline_step_full(state, drs, dsvc, dft, *lanes,
                                        lanes[0], 2, 0, lens=lens,
                                        meta=step.meta)
    assert int(out["n_miss"]) == 0
    if knob.get("count_flow_stats"):
        assert int(state.flow.octets[:-1].sum()) >= 2 * 100


@pytest.mark.parametrize("fn,knob", [
    ("pipeline_step_full", "prune_exclude")])
def test_unported_step_arguments_raise(tiny, fn, knob):
    """Every step argument of the JAX walk is ported: the mesh engine's
    spill mask, the last one refused, now steps (tests/test_torch_forwarding
    .py holds it to the JAX walk), and a keyword the walk does not have
    raises TypeError instead of being ignored."""
    cps, svc = tiny
    step, state, (drs, dsvc) = tpl.make_pipeline(
        cps, svc, flow_slots=16, aff_slots=16, device="cpu")
    lanes = [torch.zeros(4, dtype=torch.int32)] * 5
    dft = tfw.fwd_to_device(ttopo.compile_topology(ttopo.Topology()), "cpu")
    state, out = getattr(tfw, fn)(state, drs, dsvc, dft, *lanes, lanes[0],
                                  1, 0, meta=step.meta,
                                  **{knob: torch.ones(4, dtype=torch.bool)})
    assert out["code"].shape == (4,)
    with pytest.raises(TypeError, match=f"{knob}_typo"):
        getattr(tfw, fn)(state, drs, dsvc, dft, *lanes, lanes[0], 1, 0,
                         meta=step.meta, **{f"{knob}_typo": None})


@pytest.mark.parametrize("knob", [{"delta_slots": 8},
                                  # Delta patching under pruning.
                                  {"delta_slots": 1, "prune_budget": 2}])
def test_unported_table_knobs_raise(tiny, knob):
    """The delta table is ported: to_host builds the JAX package's
    DeltaTable of delta_slots empty slots (its patching is held to the
    reference in tests/test_torch_delta.py), and the match meta carries
    the capacity."""
    cluster = gen_cluster(40, n_nodes=2, pods_per_node=4, seed=1)
    from antrea_tpu.compiler.compile import compile_policy_set as jcompile

    jdrs, jmeta = jm.to_host(jcompile(cluster.ps), **knob)
    drs, meta = tm.to_host(tiny[0], **knob)
    assert meta.delta_slots == jmeta.delta_slots == knob["delta_slots"]
    for f in tm.DeltaTable._fields:
        a, b = getattr(drs.ip_delta, f), getattr(jdrs.ip_delta, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    assert drs.ip_delta.sign.shape == (knob["delta_slots"],)


def test_make_datapath_builds_the_ports_engine_on_the_cpu():
    from antrea_tpu_torch import datapath as td

    dp = td.make_datapath("tpuflow", device="cpu", flow_slots=16,
                          aff_slots=16)
    assert type(dp) is td.TpuflowDatapath
    assert type(dp).__module__ == "antrea_tpu_torch.datapath.tpuflow"
    assert dp._drs.ingress.at.inc.device.type == "cpu"
    assert dp._meta.match.delta_slots == 128  # the engine's default
    # The scalar twin: host-only numpy, no device.
    twin = td.make_datapath(td.DatapathType.ORACLE, flow_slots=16,
                            aff_slots=16)
    assert type(twin) is td.OracleDatapath
    assert type(twin).__module__ == "antrea_tpu_torch.datapath.oracle_dp"
    assert twin.datapath_type == td.DatapathType.ORACLE


def test_onepass_needs_the_aggregate_layer(tiny):
    """onepass=True over an unpruned world is refused as the JAX step
    refuses it; fused + prune_budget selects it, onepass=False pins the
    staged rounds."""
    cps, svc = tiny
    kw = dict(flow_slots=16, aff_slots=16, device="cpu")
    step, state, (drs, dsvc) = tpl.make_pipeline(cps, svc, onepass=True, **kw)
    lanes = [torch.zeros(4, dtype=torch.int32)] * 5
    with pytest.raises(ValueError, match="onepass"):
        step(state, drs, dsvc, *lanes, 1, 0)
    assert tpl.make_pipeline(cps, svc, fused=True, prune_budget=2,
                             **kw)[0].meta.onepass
    assert not tpl.make_pipeline(cps, svc, fused=True, prune_budget=2,
                                 onepass=False, **kw)[0].meta.onepass
    assert not tpl.make_pipeline(cps, svc, fused=True, **kw)[0].meta.onepass


def test_classify_summary_only_raises(tiny):
    """summary_only is ported (tests/test_torch_phases.py holds it to the
    JAX package): alone it runs, and with v6 lanes (ported since queue A
    item 5) it runs and equals the JAX package's."""
    drs, meta = tm.to_device(tiny[0], "cpu", prune_budget=2)
    lanes = [torch.zeros(4, dtype=torch.int32)] * 4
    out = tm.classify_batch(drs, *lanes, meta=meta, summary_only=True)
    assert not out["prune_fb"].any()
    from antrea_tpu.compiler.compile import compile_policy_set as jcompile
    from antrea_tpu.simulator import gen_cluster as jgen_cluster

    jdrs, jmeta = jm.to_device(jcompile(jgen_cluster(
        40, n_nodes=2, pods_per_node=4, seed=1).ps), prune_budget=2)
    rng = np.random.default_rng(2)
    w6 = rng.integers(-(2**31), 2**31, (2, 4, 4)).astype(np.int32)
    is6 = np.array([0, 1, 1, 0], np.int32)
    got = tm.classify_batch(drs, *lanes, meta=meta, summary_only=True,
                            v6=(torch.from_numpy(w6[0]),
                                torch.from_numpy(w6[1]),
                                torch.from_numpy(is6)))
    want = jm.classify_batch(jdrs, *(jnp.zeros(4, jnp.int32),) * 4,
                             meta=jmeta, summary_only=True,
                             v6=(jnp.asarray(w6[0]), jnp.asarray(w6[1]),
                                 jnp.asarray(is6)))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_constants_equal_reference():
    for name in ("MISS", "GEN_BITS", "GEN_ETERNAL", "REPLY_BIT", "PREF_MASK",
                 "CONF_BIT", "DSR_BIT", "REJECT_NONE", "REJECT_TCP_RST",
                 "REJECT_ICMP_UNREACH", "TCP_FIN", "TCP_RST", "PH_SLOW",
                 "PH_LB", "PH_CLS", "PH_COMMIT", "PH_EVICT", "PH_CLS_SUM",
                 "PH_ALL", "CHANCE_SHIFT", "CHANCE_MAX", "CHANCE_MASK",
                 "PREF_MASK_CHANCE"):
        assert getattr(tpl, name) == getattr(jpl, name), name
    assert tm.BIG == jm.BIG
    # tel_dma_hb counts the JAX one-pass kernel's half-blocks.
    assert (tpl.TEL_TILE, tpl.TEL_HALF_BLOCK) == (jm._FUSE_TB, jm._OP_HB)
    meta = tpl.PipelineMeta(match=None, flow_slots=16, aff_slots=16,
                            ct_timeout_s=1, miss_chunk=4)
    assert meta.pref_mask == tpl.PREF_MASK
    assert meta._replace(second_chance=True).pref_mask == tpl.PREF_MASK_CHANCE


def test_no_commit_mask_equals_reference():
    rng = np.random.default_rng(8)
    dst = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    dst[::5] = 0xE0000000 + dst[::5] % 2**28  # multicast
    proto = rng.choice([6, 17, 1], 512).astype(np.int32)
    flags = rng.integers(0, 64, 512).astype(np.int32)
    got = tpl.no_commit_mask(dst, proto, flags)
    want = jpl.no_commit_mask(dst, proto, flags)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def test_bit_layout_helpers_equal_reference():
    rng = np.random.default_rng(3)
    n = 2048
    code = rng.integers(0, 4, n).astype(np.int32)
    svc = rng.integers(-1, 0x3FFE, n).astype(np.int32)
    port = rng.integers(0, 65536, n).astype(np.int32)
    rin = rng.integers(-1, 0xFFFD, n).astype(np.int32)
    rout = rng.integers(-1, 0xFFFD, n).astype(np.int32)
    m1 = jpl._pack_meta1(jnp.asarray(code), jnp.asarray(svc),
                         jnp.asarray(port))
    got = tpl._pack_meta1(_t(code), _t(svc), _t(port))
    np.testing.assert_array_equal(got.numpy(), np.asarray(m1))
    for a, b in zip(tpl._unpack_meta1(got), jpl._unpack_meta1(m1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rp = jpl._pack_rules(jnp.asarray(rin), jnp.asarray(rout))
    got = tpl._pack_rules(_t(rin), _t(rout))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rp))
    for a, b in zip(tpl._unpack_rules(got), jpl._unpack_rules(rp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # (sport << 16) | dport wraps into the sign bit in JAX's int32.
    pp = (jnp.asarray(port) << 16) | jnp.asarray(port[::-1].copy())
    got = tpl._pair16(_t(port), _t(port[::-1]))
    assert (np.asarray(pp) < 0).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(pp))
    f = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(tpl._raw_bits(_t(f)).numpy(),
                                  np.asarray(jpl._raw_bits(jnp.asarray(f))))
    proto = rng.choice([6, 17, 1], n).astype(np.int32)
    np.testing.assert_array_equal(
        tpl.reject_kind_of(_t(code), _t(proto)).numpy(),
        np.asarray(jpl.reject_kind_of(jnp.asarray(code), jnp.asarray(proto))))
    conf = rng.integers(0, 2, n).astype(np.int32)
    tmo = (10, 20, 30, 40)
    np.testing.assert_array_equal(
        tpl.entry_timeout(_t(conf), _t(proto), tmo).numpy(),
        np.asarray(jpl.entry_timeout(jnp.asarray(conf), jnp.asarray(proto),
                                     tmo)))


def test_winner_mask_equals_reference():
    rng = np.random.default_rng(5)
    slots = rng.integers(0, 64, 512).astype(np.int32)  # many duplicates
    mask = rng.random(512) < 0.7
    want = jpl._winner_mask(64, jnp.asarray(slots), jnp.asarray(mask), 64)
    got = tpl._winner_mask(64, torch.from_numpy(slots.astype(np.int64)),
                           torch.from_numpy(mask), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chip_scripts_unpack_the_smoke_world(monkeypatch):
    """chip_profile.py and chip_b3_variants.py take the leading fields of
    chip_smoke.build_world()'s tuple: each call site slices it to as many
    fields as it assigns, no more than the world has (a tiny world here)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for name, val in (("N_RULES", 60), ("N_SERVICES", 4), ("B", 32),
                      ("N_FLOWS", 8), ("POOL", 16)):
        monkeypatch.setattr(chip_smoke, name, val)
    n_fields = len(chip_smoke.build_world())
    sites = 0
    for script in ("chip_profile.py", "chip_b3_variants.py"):
        tree = ast.parse((ROOT / script).read_text())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Subscript)):
                continue
            call = node.value.value
            if not (isinstance(call, ast.Call)
                    and getattr(call.func, "attr", "") == "build_world"):
                continue
            sl = node.value.slice
            assert isinstance(sl, ast.Slice) and sl.lower is None, script
            k = sl.upper.value
            assert len(node.targets[0].elts) == k <= n_fields, script
            sites += 1
    assert sites == 2


def test_no_source_names_a_module_of_the_jax_package():
    """A string naming a module of the JAX package (a `-m` target, an
    import by name) would start that package in a process of the port: no
    literal in the port's sources does.  The pipe transport spawns the
    port's own agent process."""
    pat = re.compile(r"^antrea_tpu(\.|$)")
    seen = []
    for f in sorted((ROOT / "antrea_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and pat.match(node.value)):
                seen.append((f.name, node.value))
    assert seen == []
    tree = ast.parse((ROOT / "antrea_tpu_torch" / "dissemination"
                      / "transport.py").read_text())
    lits = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)}
    assert "antrea_tpu_torch.dissemination.agent_proc" in lits


def test_agent_entry_points_default_to_the_card(monkeypatch):
    """agent_proc's tpuflow engine, SubprocessAgent(datapath_type="tpuflow")
    and antctl check resolve the card unless asked for the CPU: without
    CUDA each raises (the transport before it spawns a child)."""
    from antrea_tpu_torch import antctl
    from antrea_tpu_torch.dissemination import agent_proc, transport

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(transport.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        transport.SubprocessAgent("n0", datapath_type="tpuflow")
    assert spawned == []
    # The scalar twin (the default) needs no device and passes none.
    transport.SubprocessAgent("n0")
    assert "--device" not in spawned[0][0]
    transport.SubprocessAgent("n0", datapath_type="tpuflow", device="cpu")
    argv = spawned[1][0]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[1:3] == ["-m", "antrea_tpu_torch.dissemination.agent_proc"]
    monkeypatch.setattr(sys, "argv", ["agent_proc", "--node", "n0",
                                      "--datapath", "tpuflow"])
    with pytest.raises(RuntimeError, match="CUDA"):
        agent_proc.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        antctl.main(["check"])


# The agent slice's copies and the JAX modules they copy.  A copy differs
# from its original in its imports and in the reference paths its
# docstrings cite; where the port changes a copy, only the named
# definitions (and the module docstring) differ or are added.
_COPIES = {
    "dissemination/store.py": (), "dissemination/netwire.py": (),
    "agent/__init__.py": (),
    # The policy list kept through a uid index (the same list, order
    # included; tests/test_torch_agent.py holds it to the JAX agent).
    "agent/controller.py": ("AgentPolicyController.__init__",
                            "AgentPolicyController._handle_event",
                            "AgentPolicyController._policy_index"),
    "agent/noderoute.py": (), "agent/fqdn.py": (),
    "agent/packetcapture.py": (), "agent/apiserver.py": (),
    "controller/traceflow.py": (), "controller/endpoint_querier.py": (),
    "observability/agentinfo.py": (), "observability/supportbundle.py": (),
    # The port's child process: its own module, no JAX_PLATFORMS, a device.
    "dissemination/transport.py": ("__doc__", "SubprocessAgent.__init__"),
    "dissemination/agent_proc.py": ("main",),
    # check's engines take --device.
    "antctl.py": ("__doc__", "_cmd_check", "main"),
    # It also names the modules the port holds (serde, faults).
    "dissemination/__init__.py": ("__doc__",),
    # The fleet, the status plane, the controller's API and the node
    # agent's host programs.
    "simulator/fleet.py": (), "controller/status.py": (),
    "controller/apiserver.py": (), "controller/certificates.py": (),
    "controller/egress.py": (), "controller/externalippool.py": (),
    "controller/externalnode.py": (), "controller/serviceexternalip.py": (),
    "controller/stats.py": (), "observability/audit.py": (),
    "agent/packetin.py": (), "agent/multicast.py": (),
    "agent/nodeportlocal.py": (), "agent/cni.py": (),
    "agent/secondarynetwork.py": (), "agent/memberlist.py": (),
    "agent/bgp.py": (), "agent/bgp_wire.py": (),
    "agent/ipassigner.py": (), "agent/ipsec.py": (),
    "agent/monitortool.py": (), "agent/route.py": (),
    "agent/wireguard.py": (), "multicluster/__init__.py": (),
    "multicluster/core.py": (), "multicluster/gateway.py": (),
    "clusteridentity.py": (),
    # Its usage line names the port's module.
    "agent/gossip.py": ("main",),
    # The analysis passes carried over: their anchors name the port's
    # paths (check), their docstrings the port.
    "analysis/__init__.py": ("__doc__",),
    "analysis/audit_plane.py": ("__doc__", "check"),
    "analysis/bounded_buffer.py": ("check",),
    "analysis/canonical_shape.py": ("__doc__", "_scan_function", "check"),
    "analysis/commit_plane.py": ("__doc__", "check"),
    "analysis/events.py": ("__doc__", "check"),
    "analysis/maintenance.py": ("__doc__", "check"),
    "analysis/tenant.py": ("__doc__", "check"),
    "analysis/threads.py": ("__doc__", "check"),
}


class _NoImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def _definitions(path: Path, reference: bool) -> list:
    """[(name, AST dump)] of a module's top-level statements, imports set
    aside, a class's methods listed one by one."""
    src = path.read_text()
    if reference:
        # The JAX docstrings cite the reference source under a checkout
        # prefix that the copies drop.
        src = re.sub(r"/\w+/reference/", "", src)
    tree = _NoImports().visit(ast.parse(src))
    out = []
    for k, node in enumerate(tree.body):
        if (k == 0 and isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Constant)):
            out.append(("__doc__", ast.dump(node)))
        elif isinstance(node, ast.ClassDef):
            body = []
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((f"{node.name}.{sub.name}", ast.dump(sub)))
                else:
                    body.append(ast.dump(sub))
            out.append((node.name, repr(([ast.dump(b) for b in node.bases],
                                         body))))
        else:
            out.append((getattr(node, "name", f"<{k}>"), ast.dump(node)))
    return out


@pytest.mark.parametrize("rel", sorted(_COPIES))
def test_copied_module_equals_its_original(rel):
    port = _definitions(ROOT / "antrea_tpu_torch" / rel, False)
    ref = _definitions(ROOT / "antrea_tpu" / rel, True)
    allowed = set(_COPIES[rel])
    assert [n for n, _ in port if n not in allowed] == [
        n for n, _ in ref if n not in allowed]
    port, ref = dict(port), dict(ref)
    differ = {n for n in port.keys() | ref.keys()
              if port.get(n) != ref.get(n)}
    assert differ == allowed
