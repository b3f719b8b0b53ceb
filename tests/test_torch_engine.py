"""The PyTorch port's datapath engine (antrea_tpu_torch/datapath) against the
JAX package's TpuflowDatapath, on the CPU: the same numpy-seeded worlds and
batches through both engines, in the staged unfused (the default), staged
fused and one-pass modes, through steps, bundles, group deltas (set, clear,
set then clear, a no-op, the overflow and named-port folds), a topology
install, trace, dump_flows, the stats and the state tensors; the commit and
audit planes; the table digests; every knob the port refuses; and the knobs
of the async slow path and the step, which tests/test_torch_async.py and
tests/test_torch_knobs.py hold to the JAX engine.  Every value is an int32
or u32 word, so the tolerance is exact equality (the
flow-cache and affinity tables row for row, the dump row excluded).  The
JAX side runs its Pallas kernels in interpret mode, as its own tests do."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax

from antrea_tpu.apis import controlplane as jcp
from antrea_tpu.compiler import topology as jtopo
from antrea_tpu.datapath import BundleQuarantinedError as JQuarantined
from antrea_tpu.datapath import CanaryMismatchError as JCanaryMismatch
from antrea_tpu.datapath import OracleDatapath as JOracle
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.dissemination.faults import FaultPlan as JFaultPlan
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.packet import PacketBatch as JBatch
from antrea_tpu.simulator import gen_cluster, gen_traffic
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch import packet as tpk
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.datapath import BundleQuarantinedError as TQuarantined
from antrea_tpu_torch.datapath import CanaryMismatchError as TCanaryMismatch
from antrea_tpu_torch.dissemination import serde as tserde
from antrea_tpu_torch.dissemination.faults import FaultPlan as TFaultPlan
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.ops import consumer as tc
from antrea_tpu_torch.ops import onepass as top

KW = dict(flow_slots=1 << 12, aff_slots=1 << 10, miss_chunk=64,
          delta_slots=6, canary_probes=0)
MODES = {"staged": {}, "fused": {"fused": True},
         "onepass": {"fused": True, "prune_budget": 2}}
_FIELDS = ("code", "est", "reply", "reject_kind", "snat", "dsr", "svc_idx",
           "dnat_ip", "dnat_port", "committed", "spoofed", "punt",
           "mcast_idx", "l7_redirect", "fwd_kind", "out_port", "peer_ip",
           "dec_ttl", "tc_act", "tc_port")


def port_ps(ps):
    """A JAX-package PolicySet as the port's, through the wire format."""
    return tserde.decode_policy_set(jserde.encode_policy_set(ps))


def port_svcs(svcs):
    return [tserde.decode_service_entry(jserde.encode_service_entry(s))
            for s in svcs]


def tb(b):
    """A JAX-package PacketBatch as the port's."""
    return tpk.PacketBatch(**{f.name: getattr(b, f.name)
                              for f in dataclasses.fields(b)})


def batch(cluster, services, n, seed):
    tr = gen_traffic(cluster.pod_ips, n, n_flows=max(8, n // 3), seed=seed,
                     services=services, svc_fraction=0.3)
    return JBatch(src_ip=tr.src_ip, dst_ip=tr.dst_ip, proto=tr.proto,
                  src_port=tr.src_port, dst_port=tr.dst_port)


def diff(a, b, what):
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, (what, f)
            continue
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=f"{what}: {f}")
    assert a.n_miss == b.n_miss, what
    assert a.ingress_rule == b.ingress_rule, what
    assert a.egress_rule == b.egress_rule, what
    assert b.pending is None


def same_state(j, t, what):
    js = jax.device_get(j._state)
    for part in ("flow", "aff"):
        jt, tt = getattr(js, part), getattr(t._state, part)
        for f in jt._fields:
            np.testing.assert_array_equal(
                getattr(tt, f).numpy()[:-1], np.asarray(getattr(jt, f))[:-1],
                err_msg=f"{what}: {part}.{f}")


def same_surfaces(j, t, now, what):
    assert j.generation == t.generation, what
    assert j.dump_flows(now) == t.dump_flows(now), what
    assert j.cache_stats() == t.cache_stats(), what
    assert dataclasses.asdict(j.stats()) == dataclasses.asdict(t.stats()), what
    jp, tp = j.prune_stats(), t.prune_stats()
    if jp is None:
        assert tp is None
    else:
        for k in ("budget", "skips_total", "fallbacks_total",
                  "classified_total", "retunes_total", "autotune"):
            assert jp[k] == tp[k], (what, k)
    same_state(j, t, what)


def node0(mod, cluster, n_nodes=4, pods_per_node=8):
    """Node-0's topology of a gen_cluster world (pods at 10.0.<node>.x)."""
    return mod.Topology(
        node_name="node-0", gateway_ip="10.0.0.1", pod_cidr="10.0.0.0/24",
        local_pods=[(iputil.u32_to_ip(int(u)), 3 + i)
                    for i, u in enumerate(cluster.pod_ips[:pods_per_node])],
        remote_nodes=[mod.NodeRoute(name=f"node-{k}",
                                    node_ip=f"192.168.0.{k + 1}",
                                    pod_cidr=f"10.0.{k}.0/24")
                      for k in range(1, n_nodes)])


def engine_world():
    """A 120-rule, 12-service world, and an 80-rule one to bundle in."""
    cluster = gen_cluster(120, n_nodes=4, pods_per_node=8, seed=3)
    services = gen_services(12, cluster.pod_ips, seed=4)
    other = gen_cluster(80, n_nodes=4, pods_per_node=8, seed=99)
    return cluster, services, other


@pytest.fixture(scope="module")
def world():
    return engine_world()


def pair(cluster, services, **kw):
    kw = {**KW, **kw}
    j = JEngine(copy.deepcopy(cluster.ps), services, **kw)
    t = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu", **kw)
    return j, t


def step_both(j, t, b, now, what):
    rj, rt = j.step(b, now), t.step(tb(b), now)
    diff(rj, rt, what)
    return rj, rt


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_engine_equals_reference(world, mode):
    """The staged modes (the one-pass mode: tests/test_torch_delta.py)."""
    engine_scenario(world, mode)


def engine_scenario(world, mode):
    """Steps, trace, group deltas (a set and a clear slot, then a set and
    a clear of one address, a no-op, the overflow fold), a bundle and a
    topology install, each held to the JAX engine with every surface and
    the state tensors."""
    cluster, services, other = world
    j, t = pair(cluster, services, **MODES[mode])
    assert t._meta.onepass == j._meta.onepass == (mode == "onepass")
    launches = tc.launches, top.launches
    b0 = batch(cluster, services, 192, 10)
    for i in range(3):
        step_both(j, t, batch(cluster, services, 192, 10 + i), 100 + i,
                  f"{mode} step {i}")
    same_surfaces(j, t, 103, f"{mode} steps")
    assert j.trace(b0, 103) == t.trace(tb(b0), 103)

    # A member out, a newcomer in: one clear and one set slot.
    ag = sorted(cluster.ps.address_groups)[0]
    victim = cluster.ps.address_groups[ag].members[0].ip
    new = "10.9.9.9"
    assert (j.apply_group_delta(ag, [new], [victim])
            == t.apply_group_delta(ag, [new], [victim]))
    assert t._n_deltas == j._n_deltas >= 1
    assert t._meta.delta_n == t._meta_step.delta_n == t._n_deltas
    b1 = batch(cluster, services, 160, 22)
    b1.src_ip[:32] = iputil.ip_to_u32(new)
    b1.dst_ip[32:64] = iputil.ip_to_u32(victim)
    fb0 = (t.prune_stats() or {}).get("fallbacks_total", 0)
    step_both(j, t, b1, 110, f"{mode} delta")
    if mode == "onepass":
        # The newcomer's lanes, covered by a set slot, took the forced
        # fallback (the JAX engine's count is compared below).
        assert t.prune_stats()["fallbacks_total"] - fb0 >= 32
    # Set, then clear, of the same address: both slots stay pending.
    n0 = t._n_deltas
    x = "10.0.1.250"
    for added, removed in (([x], []), ([], [x])):
        assert (j.apply_group_delta(ag, added, removed)
                == t.apply_group_delta(ag, added, removed))
    assert t._n_deltas == j._n_deltas == n0 + 2
    b2 = batch(cluster, services, 160, 23)
    b2.src_ip[::5] = iputil.ip_to_u32(x)
    step_both(j, t, b2, 111, f"{mode} set-then-clear")
    assert j.trace(b2, 111) == t.trace(tb(b2), 111)
    # A refcount-only re-add keeps the generation on both.
    present = cluster.ps.address_groups[ag].members[1].ip
    g = t.generation
    assert t.apply_group_delta(ag, [present], []) == g
    assert j.apply_group_delta(ag, [present], []) == g
    same_surfaces(j, t, 111, f"{mode} deltas")
    # Overflow: more slots than delta_slots fold into a recompile.
    for i in range(4):
        ip = f"10.7.7.{i + 1}"
        assert (j.apply_group_delta(ag, [ip], [])
                == t.apply_group_delta(ag, [ip], []))
    assert t._n_deltas == j._n_deltas < n0 + 2 + 4
    b3 = batch(cluster, services, 160, 24)
    b3.src_ip[:4] = [iputil.ip_to_u32(f"10.7.7.{i + 1}") for i in range(4)]
    step_both(j, t, b3, 112, f"{mode} overflow")
    same_surfaces(j, t, 112, f"{mode} overflow")

    # A bundle: established flows survive, cached attribution follows
    # rule identity.
    assert (j.install_bundle(ps=copy.deepcopy(other.ps))
            == t.install_bundle(ps=port_ps(other.ps)))
    step_both(j, t, b0, 120, f"{mode} bundle")
    # A topology: node-0's pods local, the other nodes remote.
    j.install_topology(node0(jtopo, cluster))
    t.install_topology(node0(ttopo, cluster))
    b4 = batch(cluster, services, 192, 30)
    step_both(j, t, b4, 121, f"{mode} topology")
    assert j.trace(b4, 121) == t.trace(tb(b4), 121)
    same_surfaces(j, t, 121, f"{mode} end")
    # CPU tensors never launch a kernel.
    assert (tc.launches, top.launches) == launches


def test_engine_equals_oracle(world):
    """The staged engine's verdicts against the JAX package's scalar
    OracleDatapath, before and after a group delta."""
    cluster, services, _ = world
    t = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu", **KW)
    o = JOracle(copy.deepcopy(cluster.ps), services,
                flow_slots=KW["flow_slots"], aff_slots=KW["aff_slots"])
    for i in range(2):
        b = batch(cluster, services, 160, 40 + i)
        rt, ro = t.step(tb(b), 50 + i), o.step(b, 50 + i)
        for f in ("code", "est", "svc_idx", "dnat_ip", "dnat_port",
                  "committed"):
            assert getattr(rt, f).tolist() == getattr(ro, f).tolist(), f
    ag = sorted(cluster.ps.address_groups)[1]
    assert (t.apply_group_delta(ag, ["10.9.8.7"], [])
            == o.apply_group_delta(ag, ["10.9.8.7"], []))
    b = batch(cluster, services, 160, 43)
    b.dst_ip[:40] = iputil.ip_to_u32("10.9.8.7")
    rt, ro = t.step(tb(b), 60), o.step(b, 60)
    assert rt.code.tolist() == ro.code.tolist()
    assert rt.ingress_rule == ro.ingress_rule
    assert rt.egress_rule == ro.egress_rule


def test_delta_matches_fresh_compile(world):
    """tests/test_datapath.py's test_delta_matches_fresh_compile on the
    port: deltas on an address group and an appliedTo group leave the
    compiled tables in place, and fresh flows classify as on an engine
    built from the post-delta PolicySet (the engine keeps _ps in sync)."""
    cluster, services, _ = world
    t = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu", **{**KW, "delta_slots": 64})
    ag = sorted(cluster.ps.address_groups)[1]
    atg = sorted(cluster.ps.applied_to_groups)[2]
    inc0 = t._drs.ingress.at.inc
    t.apply_group_delta(ag, ["10.8.8.8"], [])
    victim = cluster.ps.applied_to_groups[atg].members[-1].ip
    t.apply_group_delta(atg, [], [victim])
    assert t._drs.ingress.at.inc is inc0 and t._n_deltas > 0
    fresh = td.TpuflowDatapath(copy.deepcopy(t._ps), port_svcs(services),
                               device="cpu", **KW)
    b = tb(batch(cluster, services, 256, 31))
    b.src_ip[:16] = iputil.ip_to_u32("10.8.8.8")
    b.dst_ip[16:48] = iputil.ip_to_u32(victim)
    ra, rb = t.step(b, 80), fresh.step(b, 80)
    assert ra.code.tolist() == rb.code.tolist()
    assert ra.dnat_ip.tolist() == rb.dnat_ip.tolist()
    assert ra.ingress_rule == rb.ingress_rule
    assert ra.egress_rule == rb.egress_rule


def _named_port_world(cp, ir):
    """tests/test_named_ports.py's world: a K8s rule on the named port
    "http" of two web pods, from a clients group."""
    def member(ip, ports=()):
        return cp.GroupMember(ip=ip, node="n0", ports=tuple(ports))

    ps = ir.PolicySet()
    ps.applied_to_groups["web"] = cp.AppliedToGroup(name="web", members=[
        member("10.0.0.10", [("http", 8080, 6)]),
        member("10.0.0.11", [("http", 9090, 6)])])
    ps.address_groups["clients"] = cp.AddressGroup(
        name="clients", members=[member("10.0.1.5")])
    ps.policies.append(cp.NetworkPolicy(
        uid="np1", name="allow-http", namespace="ns",
        type=cp.NetworkPolicyType.K8S, applied_to_groups=["web"],
        policy_types=[cp.Direction.IN],
        rules=[cp.NetworkPolicyRule(
            direction=cp.Direction.IN,
            from_peer=cp.NetworkPolicyPeer(address_groups=["clients"]),
            services=[cp.Service(protocol=6, port_name="http")])]))
    return ps


def test_named_ports_fold_every_delta_into_a_recompile():
    from antrea_tpu.compiler import ir as jir
    from antrea_tpu_torch.apis import controlplane as tcp
    from antrea_tpu_torch.compiler import ir as tir

    j = JEngine(_named_port_world(jcp, jir), **KW)
    t = td.TpuflowDatapath(_named_port_world(tcp, tir), device="cpu", **KW)
    assert t._has_named_ports and j._has_named_ports
    drs0 = t._drs
    assert (j.apply_group_delta("clients", ["10.0.1.6"], [])
            == t.apply_group_delta("clients", ["10.0.1.6"], []))
    assert t._n_deltas == j._n_deltas == 0 and t._drs is not drs0
    src = [iputil.ip_to_u32(a) for a in ("10.0.1.5", "10.0.1.6", "10.0.1.7")]
    b = JBatch(src_ip=np.array(src * 2, np.uint32),
               dst_ip=np.array([iputil.ip_to_u32("10.0.0.10")] * 3
                               + [iputil.ip_to_u32("10.0.0.11")] * 3,
                               np.uint32),
               proto=np.full(6, 6, np.int32),
               src_port=np.arange(6, dtype=np.int32) + 40000,
               dst_port=np.array([8080] * 3 + [9090] * 3, np.int32))
    rj, rt = j.step(b, 5), t.step(tb(b), 5)
    diff(rj, rt, "named ports")
    assert rt.code.tolist() == [0, 0, 1, 0, 0, 1]


def test_canary_certifies_deltas_and_quarantines_a_bundle(world):
    """With canary probes on, a delta commits certified; an injected
    canary failure rolls a bundle back, degrades the engine and
    quarantines deltas; a clean bundle recovers, on both packages."""
    cluster, services, other = world
    j, t = pair(cluster, services, canary_probes=16)
    ag = sorted(cluster.ps.address_groups)[0]
    for dp, plan in ((j, JFaultPlan()), (t, TFaultPlan())):
        dp.arm_commit_faults(plan, "n1")
        dp._plan = plan
    assert (j.apply_group_delta(ag, ["10.9.9.1"], [])
            == t.apply_group_delta(ag, ["10.9.9.1"], []))
    keys = ("canary_probes_total", "canary_mismatches_total",
            "rollbacks_total", "degraded", "lkg_generation",
            "quarantined_deltas_total")
    js, ts = j.commit_stats(), t.commit_stats()
    assert {k: js[k] for k in keys} == {k: ts[k] for k in keys}
    assert ts["canary_probes_total"] > 0 and ts["degraded"] == 0
    g = t.generation
    for dp, err, qerr, ps in ((j, JCanaryMismatch, JQuarantined,
                               copy.deepcopy(other.ps)),
                              (t, TCanaryMismatch, TQuarantined,
                               port_ps(other.ps))):
        dp._plan.after("n1.canary", dp._plan.hits("n1.canary"), "fail",
                       times=1)
        with pytest.raises(err):
            dp.install_bundle(ps=ps)
        assert dp.generation == g and dp.degraded
        with pytest.raises(qerr):
            dp.apply_group_delta(ag, ["10.9.9.2"], [])
    js, ts = j.commit_stats(), t.commit_stats()
    assert {k: js[k] for k in keys} == {k: ts[k] for k in keys}
    b = batch(cluster, services, 96, 70)
    step_both(j, t, b, 80, "lkg")
    assert (j.install_bundle(ps=copy.deepcopy(other.ps))
            == t.install_bundle(ps=port_ps(other.ps)) == g + 1)
    assert not t.degraded and not j.degraded
    step_both(j, t, b, 81, "recovered")


def test_maintenance_audit_and_repair(world):
    """maintenance_tick runs the canary, the audit window and the scrub
    with no divergence; a flipped cached verdict (an accounted mutation,
    so only the row checks see it) and a flipped service word are found
    and repaired; the audit counters match the JAX engine's."""
    cluster, services, _ = world
    j, t = pair(cluster, services, canary_probes=8, audit_window=1 << 11)
    b = batch(cluster, services, 192, 90)
    step_both(j, t, b, 200, "warm")
    for k in range(3):
        oj, ot = j.maintenance_tick(201 + k), t.maintenance_tick(201 + k)
        assert oj["ran"] == ot["ran"]
    keys = ("divergences", "repairs_total", "scrub")
    for dp in (j, t):
        st = dp.audit_stats()
        assert not st["divergences"] and not st["scrub"].get("corrupt")
        assert "tensor-scrub" in dp.maintenance_stats()["tasks"]
    for dp in (j, t):
        assert "verdict" in dp._audit_corrupt("verdict", now=210)
        dp._state_mutations += 1
        for i in range(4):
            if dp.audit_scan(now=211 + i)["repaired"]:
                break
        assert dp.audit_stats()["repairs_total"] >= 1
        assert "flip" in dp._audit_corrupt("tensor")
        out = dp.audit_scan(now=220)
        assert out.get("healed"), out
    js, ts = j.audit_stats(), t.audit_stats()
    assert {k: js[k] for k in keys} == {k: ts[k] for k in keys}
    step_both(j, t, b, 230, "repaired")
    same_state(j, t, "repaired")


def test_tensor_digest_equals_reference(world):
    """The scrub digests of the rule, service, forwarding and state
    tensors equal the JAX package's on the same tables, pending deltas
    included, and a one-bit flip moves them."""
    cluster, services, _ = world
    j, t = pair(cluster, services, prune_budget=2)
    ag = sorted(cluster.ps.address_groups)[0]
    j.apply_group_delta(ag, ["10.9.9.3"], [])
    t.apply_group_delta(ag, ["10.9.9.3"], [])
    b = batch(cluster, services, 128, 95)
    step_both(j, t, b, 300, "digest")
    assert j._audit_rule_digests() == t._audit_rule_digests()
    assert j._audit_state_digest() == t._audit_state_digest()
    d0 = tpl.tensor_digest(tpl.tree_leaves(t._drs))
    assert d0 == jpl.tensor_digest(jax.tree_util.tree_leaves(j._drs))
    inc = t._drs.ingress.peer.inc.clone()
    inc[0, 0] ^= 1 << 31
    flipped = t._drs._replace(ingress=t._drs.ingress._replace(
        peer=t._drs.ingress.peer._replace(inc=inc)))
    assert tpl.tensor_digest(tpl.tree_leaves(flipped)) != d0


@pytest.mark.parametrize("knob", [
    {"async_slowpath": True},
    {"async_slowpath": True, "autotune_drain": True},
    {"async_slowpath": True, "overlap_commits": True},
    {"async_slowpath": True, "miss_source_rate": 4.0,
     "miss_source_burst": 16},
    {"second_chance": True}, {"telemetry": True},
    {"feature_gates": "FlowExporter"}, {"dual_stack": True},
    {"serving_batcher": True, "canonical_sizes": (16, 64)},
    {"persist_dir": "tmp"},
], ids=["async_slowpath", "autotune_drain", "overlap_commits",
        "miss_source_rate", "second_chance", "telemetry", "FlowExporter",
        "dual_stack", "serving_batcher", "persist_dir"])
def test_formerly_refused_knobs_construct_and_step(world, knob, tmp_path):
    """The knobs of queue A items 3, 4, 5, 6 and 8 (refused until they were
    ported) build an engine on the CPU that steps, drains and ticks; the
    async ones admit the misses a step leaves pending; a dual-stack engine
    reports the wide views (tests/test_torch_dual_stack_engine.py holds it
    to the JAX engine); the serving batcher takes the same lanes through
    step_tenants; a persist dir holds the snapshot a bundle wrote
    (tests/test_torch_serving.py and tests/test_torch_persistence.py hold
    both to the JAX engine)."""
    if knob.get("feature_gates"):
        from antrea_tpu_torch.features import FeatureGates

        knob = {"feature_gates": FeatureGates({"FlowExporter": True})}
    if knob.get("persist_dir"):
        knob = {"persist_dir": str(tmp_path)}
    cluster, services, _ = world
    t = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu", **{**KW, **knob})
    b = tb(batch(cluster, services, 64, 2))
    r = t.step(b, 10)
    assert r.code.shape == (64,) and r.n_miss > 0
    if knob.get("async_slowpath"):
        assert (r.pending != 0).any() and t.slowpath_stats()["depth"] > 0
        assert t.drain_slowpath(11)["drained"] > 0
        assert t.flush_slowpath() >= 0
    else:
        assert r.pending is None and t.slowpath_stats() is None
    t.maintenance_tick(12)
    r2 = t.step(b, 13)
    assert r2.n_miss < r.n_miss
    if knob.get("telemetry"):
        assert t.telemetry_stats()["steps_total"] == 2
    if "feature_gates" in knob:
        assert sum(f["packets"] for f in t.dump_flows(13)) > 0
    assert (r2.dnat_key is not None) == bool(knob.get("dual_stack"))
    if knob.get("serving_batcher"):
        r3 = t.step_tenants(np.zeros(64, np.int64), b, 14)
        np.testing.assert_array_equal(r3.code, r2.code)
        assert t.serving_stats()["dispatches"] == 1
    if knob.get("persist_dir"):
        from antrea_tpu_torch.datapath import persist

        assert t.install_bundle(services=port_svcs(services)) == 1
        assert persist.load_snapshot(knob["persist_dir"])[2] == 1
        assert t._conf_store is not None


def test_refused_surfaces_name_their_roadmap_item(world):
    cluster, services, _ = world
    t = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu", **KW)
    from antrea_tpu_torch import parallel

    # The mesh engine and its resize and failover planes are ported; what
    # they refuse is the JAX engine's refusals.
    mdp = parallel.MeshDatapath(port_ps(cluster.ps), port_svcs(services),
                                n_data=2, n_rule=1, device="cpu", **KW)
    with pytest.raises(RuntimeError, match="no reshard in flight"):
        mdp.reshard_abort()
    with pytest.raises(RuntimeError, match="failover plane is not enabled"):
        mdp.failover_readmit()
    assert mdp.reshard_begin(4)["n_data_to"] == 4
    with pytest.raises(RuntimeError, match="already in flight"):
        mdp.reshard_begin(4)
    # A v6 batch is refused like the JAX engine refuses it (v4-only).
    with pytest.raises(ValueError, match="v4-only"):
        t.step(tpk.PacketBatch(src_ip=np.zeros(1, np.uint32),
                               dst_ip=np.zeros(1, np.uint32),
                               proto=np.zeros(1, np.int32),
                               src_port=np.zeros(1, np.int32),
                               dst_port=np.zeros(1, np.int32),
                               src_ip6=np.ones((1, 4), np.uint32),
                               dst_ip6=np.ones((1, 4), np.uint32),
                               is6=np.ones(1, np.int32)), 1)


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.TpuflowDatapath()
    with pytest.raises(RuntimeError, match="CUDA"):
        td.TpuflowDatapath(dual_stack=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.TpuflowDatapath(serving_batcher=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.TpuflowDatapath(persist_dir="never-written")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.make_datapath("tpuflow")
    t = td.make_datapath("tpuflow", device="cpu", flow_slots=16,
                         aff_slots=16)
    assert isinstance(t, td.TpuflowDatapath)
    assert t.device.type == "cpu" and t._state.flow.keys.device.type == "cpu"
    assert t.datapath_type == td.DatapathType.TPUFLOW
