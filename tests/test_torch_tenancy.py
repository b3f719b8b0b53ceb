"""Tenant worlds on the PyTorch port's engine (datapath/tenancy.py through
antrea_tpu_torch's TpuflowDatapath and its scalar twin OracleDatapath),
held to the JAX package on the CPU.

The same numpy-seeded worlds and batches go through the port's engine and
the JAX engine, in the staged unfused, staged fused and one-pass modes, and
through the async slow path with the per-tenant admission clamp: every
StepResult field, each world's flow-cache and affinity tables (the dump row
excluded), tenant_stats() and tenant_dump_flows() are equal.  Every value is
an int32 or u32 word, so there is no tolerance.  The JAX side runs its
Pallas kernels in interpret mode, as its own tests do.  The port's own
pillars (packed against single-tenant parity, the canary veto of one
tenant, the rung floor, the config rejections, the default world unchanged
by tenancy) are the analogues of tests/test_tenancy.py, and the engine's
per-world swap set is pinned."""

import copy
import dataclasses

import numpy as np
import pytest

import jax

from antrea_tpu.datapath import OracleDatapath as JOracle
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.datapath.commit import CanaryMismatchError as JCanary
from antrea_tpu.datapath.slowpath import engine as jengine
from antrea_tpu.dissemination.faults import FaultPlan as JFaultPlan
from antrea_tpu.simulator import gen_cluster, gen_traffic
from antrea_tpu.simulator.traffic import gen_cache_thrash, gen_syn_flood
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.config import ConfigError
from antrea_tpu_torch.datapath.commit import CanaryMismatchError as TCanary
from antrea_tpu_torch.datapath.slowpath import engine as tengine
from antrea_tpu_torch.datapath.tpuflow import _RuleIds
from antrea_tpu_torch.dissemination.faults import FaultPlan as TFaultPlan

from test_torch_engine import port_ps, tb
import torch_cpu  # noqa: F401  (one torch thread a worker)

QUOTA = 1 << 8
AFFQ = 1 << 6
KW = dict(flow_slots=1 << 10, aff_slots=1 << 8, flightrec_slots=256,
          realization_slots=16, canary_probes=0)
MODES = {"staged": {}, "fused": {"fused": True},
         "onepass": {"fused": True, "prune_budget": 2}}


@pytest.fixture(autouse=True)
def one_salt(monkeypatch):
    """Both packages draw their early-drop salt from os.urandom once per
    process: parity under shedding needs one value in both."""
    salt = np.uint32(0x5EED)
    monkeypatch.setattr(jengine, "_EARLY_DROP_SALT", salt)
    monkeypatch.setattr(tengine, "_EARLY_DROP_SALT", salt)


def worlds(n=2, base_seed=11, rule_counts=(8, 70)):
    """n tenant worlds with uneven rule sets (two rungs by default)."""
    return [gen_cluster(rule_counts[i % len(rule_counts)], n_nodes=2,
                        pods_per_node=8, seed=base_seed + i)
            for i in range(n)]


def batch(cluster, n, seed):
    return gen_traffic(cluster.pod_ips, n, n_flows=max(8, n // 2),
                       seed=seed)


def pair(clusters, base=None, **kw):
    """The JAX engine and the port's engine (CPU) with the same tenant
    worlds -> (j, t, tids)."""
    kw = {**KW, **kw}
    j = JEngine(None if base is None else copy.deepcopy(base.ps), **kw)
    t = td.TpuflowDatapath(None if base is None else port_ps(base.ps),
                           device="cpu", **kw)
    tids = []
    for i, c in enumerate(clusters):
        a = j.tenant_create(f"t{i}", copy.deepcopy(c.ps), quota=QUOTA,
                            aff_quota=AFFQ)
        b = t.tenant_create(f"t{i}", port_ps(c.ps), quota=QUOTA,
                            aff_quota=AFFQ)
        assert a == b
        tids.append(a)
    return j, t, tids


def same_result(a, b, what):
    """Every StepResult field of the JAX engine's (a) and the port's (b)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None:
            assert y is None, (what, f.name)
        elif isinstance(x, list):
            assert x == y, (what, f.name)
        else:
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f"{what}: {f.name}")


def same_tables(js, ts, what):
    """The flow-cache and affinity tables of one world, the dump row
    excluded."""
    js = jax.device_get(js)
    for part in ("flow", "aff"):
        jt, tt = getattr(js, part), getattr(ts, part)
        for f in jt._fields:
            np.testing.assert_array_equal(
                getattr(tt, f).numpy()[:-1], np.asarray(getattr(jt, f))[:-1],
                err_msg=f"{what}: {part}.{f}")


def same_worlds(j, t, tids, now, what):
    """Each world's tables, tenant_stats(), tenant_dump_flows() and
    tenant_datapath_stats(); the default world's too."""
    same_tables(j._state, t._state, f"{what}: default world")
    assert j.tenant_stats() == t.tenant_stats(), what
    for tid in tids:
        same_tables(j._tenants.world(tid).fields["_state"],
                    t._tenants.world(tid).fields["_state"],
                    f"{what}: tenant {tid}")
        assert j.tenant_dump_flows(tid, now) == t.tenant_dump_flows(tid, now)
        assert (dataclasses.asdict(j.tenant_datapath_stats(tid))
                == dataclasses.asdict(t.tenant_datapath_stats(tid))), what
    assert j.dump_flows(now) == t.dump_flows(now), what


@pytest.mark.parametrize("mode", list(MODES))
def test_tenant_worlds_equal_jax_engine(mode):
    """Two tenant worlds on two rungs and the default world, interleaved,
    fresh round then established round, then a tenant install: the port's
    engine equals the JAX engine bitwise in every mode."""
    base = gen_cluster(20, n_nodes=2, pods_per_node=8, seed=9)
    clusters = worlds()
    j, t, tids = pair(clusters, base=base, **MODES[mode])
    assert len(t.tenant_rungs()) == len(j.tenant_rungs()) == 2
    bats = [batch(c, 64, seed=40 + i) for i, c in enumerate(clusters)]
    bd = batch(base, 64, seed=39)
    for now in (100, 101):
        for tid, b in zip(tids, bats):
            same_result(j.tenant_step(tid, b, now),
                        t.tenant_step(tid, tb(b), now),
                        f"{mode} tenant {tid} @{now}")
        same_result(j.step(bd, now), t.step(tb(bd), now),
                    f"{mode} default @{now}")
    same_worlds(j, t, tids, 102, mode)
    # A tenant install renumbers that world's rules and remaps its cache.
    ps2 = copy.deepcopy(clusters[1].ps)
    ps2.policies = ps2.policies[::-1]
    assert (j.tenant_install_bundle(tids[1], ps2)
            == t.tenant_install_bundle(tids[1], port_ps(ps2)) == 1)
    same_result(j.tenant_step(tids[1], bats[1], 103),
                t.tenant_step(tids[1], tb(bats[1]), 103), f"{mode} install")
    same_worlds(j, t, tids, 104, f"{mode} after install")


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_async_tenants_equal_jax_engine_under_attack_storm(overlap):
    """The async slow path with tenant worlds, against the JAX engine: B
    settles a hot set, then A storms (never-repeating SYN flood and a
    thrash universe far over its quota).  Every step, drain, tenant_stats()
    (the admission clamp's counts included) and table is equal; A's clamp
    engages and B loses nothing (no eviction, the same flow table).  Under
    overlap_commits each tenant drain's deferred finalizer lands in its
    owner world, as in the JAX engine."""
    clusters = worlds(2, rule_counts=(6, 6))
    j, t, (tid_a, tid_b) = pair(
        clusters, fused=True, async_slowpath=True, miss_queue_slots=1 << 10,
        drain_batch=128, overlap_commits=overlap)
    b_hot = batch(clusters[1], 64, seed=90)
    for now in (100, 102, 104):
        same_result(j.tenant_step(tid_b, b_hot, now),
                    t.tenant_step(tid_b, tb(b_hot), now), f"B hot @{now}")
        assert j.drain_slowpath(now + 1) == t.drain_slowpath(now + 1)
    j.flush_slowpath()
    t.flush_slowpath()
    same_worlds(j, t, [tid_a, tid_b], 104, "settled")
    st0 = t.tenant_stats()
    flows_b0 = t.tenant_dump_flows(tid_b, 104)
    assert st0[tid_b]["queued"] == 0
    seq = 0
    for rnd in range(3):
        flood = gen_syn_flood(clusters[0].pod_ips, 256, start_seq=seq,
                              seed=1)
        seq += 256
        thrash = gen_cache_thrash(clusters[0].pod_ips, 256,
                                  n_flows=QUOTA * 16, seed=rnd)
        for b in (flood, thrash):
            same_result(j.tenant_step(tid_a, b, 104 + rnd),
                        t.tenant_step(tid_a, tb(b), 104 + rnd),
                        f"storm {rnd}")
        assert j.drain_slowpath(110 + rnd) == t.drain_slowpath(110 + rnd)
    j.flush_slowpath()
    t.flush_slowpath()
    sj, st = j.slowpath_stats(), t.slowpath_stats()
    hj, ht = sj.pop("drain_hist"), st.pop("drain_hist")
    assert sj == st
    assert (hj._counts, hj.sum) == (ht._counts, ht.sum)
    assert j.dump_miss_queue() == t.dump_miss_queue()
    same_worlds(j, t, [tid_a, tid_b], 115, "storm")
    st = t.tenant_stats()
    assert st[tid_a]["quota_clamps_total"] > 0
    assert "tenant-quota-clamp" in {e["kind"]
                                    for e in t.flightrecorder_events()}
    assert st[tid_b]["evictions_total"] == st0[tid_b]["evictions_total"]
    assert t.tenant_dump_flows(tid_b, 115) == flows_b0
    assert st[tid_a]["evictions_total"] > 0
    # The drained rows were counted in their owner worlds only.
    base = t.stats()
    assert base.default_allow == base.default_deny == 0
    assert base.ingress == {} and base.egress == {}


def _packed(cls, clusters, **kw):
    dp = cls(**kw)
    tids = [dp.tenant_create(f"t{i}", port_ps(c.ps), quota=QUOTA,
                             aff_quota=AFFQ)
            for i, c in enumerate(clusters)]
    return dp, tids


ENGINES = {"engine": (td.TpuflowDatapath, {"device": "cpu"}),
           "twin": (td.OracleDatapath, {})}


@pytest.mark.parametrize("which", list(ENGINES))
def test_packed_vs_single_tenant_parity(which):
    """A packed two-tenant instance serves each tenant bitwise like an
    independent single-tenant instance, fresh and established rounds,
    rule ids, per-rule stats and the conntrack dump (the port's engine and
    its twin alike)."""
    cls, dev = ENGINES[which]
    clusters = worlds()
    dp, tids = _packed(cls, clusters, flow_slots=1 << 10, aff_slots=1 << 8,
                       flightrec_slots=256, realization_slots=16, **dev)
    singles = [cls(port_ps(c.ps), flow_slots=QUOTA, aff_slots=AFFQ,
                   flightrec_slots=0, realization_slots=0, **dev)
               for c in clusters]
    for now in (100, 101):
        for i, (tid, c) in enumerate(zip(tids, clusters)):
            b = tb(batch(c, 64, seed=40 + i))
            got, want = dp.tenant_step(tid, b, now), singles[i].step(b, now)
            for f in ("code", "est", "committed", "reply", "svc_idx",
                      "dnat_ip", "dnat_port", "reject_kind"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)
            assert got.ingress_rule == want.ingress_rule
            assert got.egress_rule == want.egress_rule
    for i, tid in enumerate(tids):
        assert (dataclasses.asdict(dp.tenant_datapath_stats(tid))
                == dataclasses.asdict(singles[i].stats()))
        assert (sorted(map(str, dp.tenant_dump_flows(tid, 102)))
                == sorted(map(str, singles[i].dump_flows(102))))


@pytest.mark.parametrize("which", list(ENGINES))
def test_tenant_canary_veto_rolls_back_only_that_tenant(which):
    """A forced canary mismatch on tenant A's install rolls back and
    degrades A alone: its tables stay as they were, B and the default world
    keep their generations; a re-install recovers A.  tenant_stats() after
    each step equals the JAX package's same engine given the same calls."""
    cls, dev = ENGINES[which]
    jcls = JEngine if which == "engine" else JOracle
    clusters = worlds(2, rule_counts=(10, 10))
    kw = dict(flow_slots=1 << 10, aff_slots=1 << 8, flightrec_slots=256,
              realization_slots=16)
    j = jcls(**kw)
    jt = [j.tenant_create(f"t{i}", copy.deepcopy(c.ps), quota=QUOTA,
                          aff_quota=AFFQ) for i, c in enumerate(clusters)]
    dp, (tid_a, tid_b) = _packed(cls, clusters, **kw, **dev)
    assert jt == [tid_a, tid_b]
    b = batch(clusters[0], 64, seed=3)
    j.tenant_step(tid_a, b, 100)
    dp.tenant_step(tid_a, tb(b), 100)
    before = dp.tenant_dump_flows(tid_a, 100)
    if which == "engine":
        st_before = dp._tenants.world(tid_a).fields["_state"]
    jplan, tplan = JFaultPlan(seed=1), TFaultPlan(seed=1)
    for plan, eng in ((jplan, j), (tplan, dp)):
        plan.after("dp.canary", 0, "fail", times=1)
        eng.arm_commit_faults(plan, "dp")
    ps_a2 = clusters[0].ps
    with pytest.raises(JCanary):
        j.tenant_install_bundle(tid_a, copy.deepcopy(ps_a2))
    with pytest.raises(TCanary):
        dp.tenant_install_bundle(tid_a, port_ps(ps_a2))
    st = dp.tenant_stats()
    assert st == j.tenant_stats()
    assert st[tid_a]["degraded"] == 1 and st[tid_a]["generation"] == 0
    assert st[tid_a]["rollbacks_total"] == 1
    assert st[tid_b]["degraded"] == 0 and st[tid_b]["generation"] == 0
    assert not dp.degraded and dp.generation == 0
    assert dp.tenant_dump_flows(tid_a, 100) == before
    if which == "engine":
        w = dp._tenants.world(tid_a).fields["_state"]
        for part in ("flow", "aff"):
            for f in getattr(w, part)._fields:
                assert (getattr(getattr(w, part), f).numpy().tobytes()
                        == getattr(getattr(st_before, part), f).numpy()
                        .tobytes()), (part, f)
    assert (dp.tenant_install_bundle(tid_b, port_ps(clusters[1].ps))
            == j.tenant_install_bundle(tid_b, copy.deepcopy(clusters[1].ps))
            == 1)
    assert dp.tenant_stats()[tid_a]["degraded"] == 1
    assert "tenant-rollback" in {e["kind"] for e in dp.flightrecorder_events()}
    assert dp.tenant_install_bundle(tid_a, port_ps(ps_a2)) == 1
    j.tenant_install_bundle(tid_a, copy.deepcopy(ps_a2))
    assert dp.tenant_stats() == j.tenant_stats()
    assert dp.tenant_stats()[tid_a]["degraded"] == 0


def test_tenant_config_rejections():
    dp = td.TpuflowDatapath(device="cpu", flow_slots=1 << 10,
                            aff_slots=1 << 8, flightrec_slots=0,
                            realization_slots=0)
    with pytest.raises(ConfigError):
        dp.tenant_create("bad", quota=100)  # not pow2
    with pytest.raises(ConfigError):
        dp.tenant_create("bad", quota=256, aff_quota=100)
    from antrea_tpu_torch.apis.controlplane import (
        Direction, NetworkPolicy, NetworkPolicyPeer, NetworkPolicyRule,
        RuleAction, ServiceReference)
    from antrea_tpu_torch.compiler.ir import PolicySet

    ps = PolicySet()
    ps.policies.append(NetworkPolicy(
        uid="svc-ref", name="svc-ref",
        rules=[NetworkPolicyRule(
            direction=Direction.OUT,
            to_peer=NetworkPolicyPeer(
                to_services=[ServiceReference(namespace="d", name="s")]),
            action=RuleAction.ALLOW)]))
    with pytest.raises(ConfigError):
        dp.tenant_create("svcref", ps, quota=256)
    tid = dp.tenant_create("clean", quota=256)
    with pytest.raises(ConfigError):
        dp.tenant_install_bundle(tid, ps)
    assert dp.tenant_stats()[tid]["generation"] == 0
    # A dual-stack engine has no tenant worlds: the JAX ConfigError.
    ds = td.TpuflowDatapath(device="cpu", flow_slots=1 << 8,
                            aff_slots=1 << 6, dual_stack=True,
                            flightrec_slots=0, realization_slots=0)
    with pytest.raises(ConfigError, match="v4-only"):
        ds.tenant_create("v6", quota=256)


@pytest.mark.parametrize("shapes,n_rungs", [
    (((3, 21), (4, 21)), 1), (((3, 21), (5, 22)), 2)], ids=["floor", "two"])
def test_pad_rung_floor_collapses_small_worlds(shapes, n_rungs):
    """Worlds with different small rule counts land on one rung signature
    (the phase floor and the entry floor) where the JAX engine's do, and
    the signature is hashable on the port's PipelineMeta."""
    kw = dict(flow_slots=1 << 10, aff_slots=1 << 8, flightrec_slots=0,
              realization_slots=0)
    dp = td.TpuflowDatapath(device="cpu", **kw)
    j = JEngine(**kw)
    for n, seed in shapes:
        c = gen_cluster(n, n_nodes=2, pods_per_node=4, seed=seed)
        dp.tenant_create(f"{n}", port_ps(c.ps), quota=QUOTA)
        j.tenant_create(f"{n}", copy.deepcopy(c.ps), quota=QUOTA)
    rungs = dp.tenant_rungs()
    assert len(rungs) == len(j.tenant_rungs()) == n_rungs
    assert all(isinstance(hash(r), int) for r in rungs)


def test_default_world_unchanged_by_tenancy():
    """The default world of a tenanted engine serves, and keeps its tables,
    bitwise like an untenanted instance."""
    c = gen_cluster(20, n_nodes=2, pods_per_node=8, seed=51)
    kw = dict(device="cpu", flow_slots=1 << 10, aff_slots=1 << 8,
              realization_slots=0)
    dp = td.TpuflowDatapath(port_ps(c.ps), flightrec_slots=64, **kw)
    twin = td.TpuflowDatapath(port_ps(c.ps), flightrec_slots=0, **kw)
    tid = dp.tenant_create("t", port_ps(c.ps), quota=QUOTA)
    b, bt = tb(batch(c, 48, seed=52)), tb(batch(c, 48, seed=53))
    for now in (99, 100):
        dp.tenant_step(tid, bt, now)
        r, w = dp.step(b, now + 1), twin.step(b, now + 1)
        for f in dataclasses.fields(w):
            x, y = getattr(w, f.name), getattr(r, f.name)
            assert (x is None and y is None) or np.array_equal(
                np.asarray(x, dtype=object), np.asarray(y, dtype=object)), f
    assert dp.cache_stats() == twin.cache_stats()
    for part in ("flow", "aff"):
        for f in getattr(twin._state, part)._fields:
            assert (getattr(getattr(dp._state, part), f).numpy().tobytes()
                    == getattr(getattr(twin._state, part), f).numpy()
                    .tobytes()), (part, f)


# Engine attributes shared across worlds by design (the tenancy plane's
# docstring and the engine's comment on _TENANT_WORLD_FIELDS): the prune
# plane's meters count every world's steps, as in the JAX engine.
SHARED_METERS = {"_prune_skips", "_prune_fallbacks", "_prune_classified",
                 "_prune_hist"}
# The tenancy plane's own bookkeeping (datapath/tenancy.py).
PLANE = {"_tenants", "_tenant_task_registered", "_tenant_maint_cursor"}


def test_tenant_world_fields_pin():
    """_TENANT_WORLD_FIELDS holds the JAX engine's swap set and the port's
    own per-world attributes (the rule-id caches); a world's build, steps,
    install and drain replace no engine attribute outside the set but the
    shared prune meters, and each world owns its rule-id caches."""
    jset = set(JEngine._TENANT_WORLD_FIELDS)
    tset = set(td.TpuflowDatapath._TENANT_WORLD_FIELDS)
    assert len(tset) == len(td.TpuflowDatapath._TENANT_WORLD_FIELDS)
    assert tset - jset == {"_rule_ids_in", "_rule_ids_out"}
    assert jset <= tset
    # The pins the JAX package's analysis pass holds its list to.
    from antrea_tpu.analysis.tenant import (REQUIRED_COMMIT_FIELDS,
                                            REQUIRED_WORLD_FIELDS)
    from antrea_tpu_torch.datapath.tenancy import COMMIT_WORLD_FIELDS

    assert REQUIRED_WORLD_FIELDS["datapath/tpuflow.py"] <= tset
    assert (REQUIRED_WORLD_FIELDS["datapath/oracle_dp.py"]
            <= set(td.OracleDatapath._TENANT_WORLD_FIELDS))
    assert REQUIRED_COMMIT_FIELDS <= set(COMMIT_WORLD_FIELDS)
    c = gen_cluster(12, n_nodes=2, pods_per_node=8, seed=5)
    dp = td.TpuflowDatapath(port_ps(c.ps), device="cpu", fused=True,
                            prune_budget=2, async_slowpath=True,
                            drain_batch=64, flow_slots=1 << 10,
                            aff_slots=1 << 8, canary_probes=4)
    b = tb(batch(c, 32, seed=6))
    dp.step(b, 10)
    dp.drain_slowpath(11)
    before = dict(vars(dp))
    tid = dp.tenant_create("t", port_ps(c.ps), quota=QUOTA)
    dp.tenant_step(tid, b, 12)
    dp.drain_slowpath(13)
    dp.tenant_install_bundle(tid, port_ps(c.ps))
    dp.tenant_apply_group_delta(tid, sorted(c.ps.address_groups)[0],
                                ["10.9.9.9"], [])
    dp.tenant_step(tid, b, 14)
    after = vars(dp)
    replaced = {k for k in before if after.get(k) is not before[k]}
    assert replaced <= tset | SHARED_METERS | PLANE, (
        replaced - tset - SHARED_METERS - PLANE)
    w = dp._tenants.world(tid).fields
    for name in ("_rule_ids_in", "_rule_ids_out"):
        assert isinstance(w[name], _RuleIds)
        assert w[name] is not getattr(dp, name)
    assert w["_drs"] is not dp._drs
