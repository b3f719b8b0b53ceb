"""The PyTorch port's tenant-aware resize and failover on the CPU, the
analogues of tests/test_tenant_reshard.py: resizes with tenant worlds live
(each world migrating under its own _world_ctx and certifying its own
canary on the target placement), a single world's veto latching only that
world until tenant_reshard_resync, and a replica's quarantine, evacuation
and readmission with worlds live.

One walk is held bit for bit to the JAX package's MeshDatapath: the grow
2 -> 4 with three live worlds where a FaultPlan forces one world's
canary veto, then the latched world's resync.  It runs once on the JAX
engine in a module fixture, recorded step by step, and the port must give
the same records (every StepResult field of the default world and of each
world, reshard_stats() spans aside, tenant_stats(), failover_stats(),
mesh_stats(), dump_flows(), the flight-recorder kinds in order and the
resize events whole, each topology generation); exact equality.  The other
cases hold every classified lane of every world to the port's scalar
Oracle on the world's policy, as the JAX tests do.  The recorder is
tests/test_torch_reshard.py's; the eight-world cases are in
tests/test_torch_tenant_reshard_soak.py."""

import numpy as np
import pytest

from antrea_tpu.dissemination.faults import FaultPlan as JFaultPlan
from antrea_tpu.simulator.genpolicy import gen_cluster
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu.simulator.traffic import gen_traffic
from antrea_tpu_torch.dissemination.faults import FaultPlan as TFaultPlan
from antrea_tpu_torch.oracle.interpreter import Oracle as TOracle

from test_torch_engine import port_ps, tb
from test_torch_meshpath import jps
from test_torch_reshard import (Recorder, copies_equal, jax_engine,
                                jax_trace_bucketed, port_engine,
                                same_records, stats_rec, step_rec)
import torch_cpu  # noqa: F401  (one torch thread a worker)

FO_KW = dict(probe_fails=2, readmit_passes=2, retry_ticks=2,
             probe_deadline_s=1e6, dispatch_deadline_s=1e6)
N_WORLDS = 8


@pytest.fixture(scope="module")
def world():
    cluster = gen_cluster(40, n_nodes=4, pods_per_node=6, seed=7)
    services = gen_services(4, cluster.pod_ips, seed=11)
    return cluster, services


@pytest.fixture(scope="module")
def batch(world):
    cluster, services = world
    return gen_traffic(cluster.pod_ips, 64, n_flows=32, seed=3,
                       services=services, svc_fraction=0.3)


@pytest.fixture(scope="module")
def tenant_clusters():
    return [gen_cluster(20, n_nodes=2, pods_per_node=5, seed=100 + i)
            for i in range(N_WORLDS)]


@pytest.fixture(scope="module")
def tenant_batches(tenant_clusters):
    # World 2's seed-52 batch is all denied (nothing would establish).
    return [tb(gen_traffic(c.pod_ips, 64, n_flows=24,
                           seed=56 if i == 2 else 50 + i))
            for i, c in enumerate(tenant_clusters)]


@pytest.fixture(scope="module")
def oracles(tenant_clusters):
    return [TOracle(port_ps(c.ps)) for c in tenant_clusters]


_WANT = {}


def want_codes(oracle, b):
    """The Oracle's codes of a fixed batch under a fixed world, once."""
    key = (id(oracle), id(b))
    hit = _WANT.get(key)
    if hit is None or hit[0] is not oracle or hit[1] is not b:
        codes = np.asarray([int(oracle.classify(b.packet(j)).code)
                            for j in range(b.size)])
        _WANT[key] = hit = (oracle, b, codes)
    return hit[2]


def parity(oracle, b, r, msg):
    """Every classified lane's code equal to the Oracle's."""
    live = (np.ones(b.size, bool) if r.pending is None
            else np.asarray(r.pending) == 0)
    codes, want = np.asarray(r.code), want_codes(oracle, b)
    bad = live & (codes != want)
    assert not bad.any(), (msg, int(np.argmax(bad)))


def step_worlds(dp, tids, tbs, oracles, t, msg):
    for i, tid in enumerate(tids):
        parity(oracles[i], tbs[i], dp.tenant_step(tid, tbs[i], t),
               f"{msg} w{tid} t={t}")


def resize_under_traffic(dp, b, tids, tbs, oracles, t, deadline=400):
    while dp.reshard_status() is not None:
        dp.step(b, t)
        step_worlds(dp, tids, tbs, oracles, t, "mid-resize")
        dp.maintenance_tick(now=t)
        t += 1
        assert t < deadline, dp.reshard_status()
    return t


def tenants(dp, tenant_clusters, conv, n=N_WORLDS):
    return [dp.tenant_create(f"w{i}", conv(tenant_clusters[i].ps), quota=64)
            for i in range(n)]


# ---- the walk held to the JAX engine ----------------------------------------


def walk_tenant_veto(dp, cb, cps, plan_cls, batch, tenant_clusters,
                     tenant_batches):
    """Three live worlds; world 2's canary is forced to veto at the grow's
    cutover; the fleet and the other worlds flip, world 2 latches and
    serves its old topology until tenant_reshard_resync re-homes it."""
    rec = Recorder()
    tids = tenants(dp, tenant_clusters, cps, n=3)
    tbs = [b if cb is tb else _jbatch(b) for b in tenant_batches[:3]]
    dp.step(cb(batch), 100)
    for i, tid in enumerate(tids):
        rec.add(f"w{tid} 100", step_rec(dp.tenant_step(tid, tbs[i], 100)))
    victim = tids[1]
    plan = plan_cls(seed=9)
    plan.every(f"n0.tenant_canary.t{victim}", 1, "forced", times=1)
    dp.arm_reshard_faults(plan, "n0")
    rec.add("begin", dp.reshard_begin(4))
    t = 101
    while dp.reshard_status() is not None:
        rec.add(f"default t={t}", step_rec(dp.step(cb(batch), t)))
        for i, tid in enumerate(tids):
            rec.add(f"w{tid} t={t}", step_rec(dp.tenant_step(tid, tbs[i], t)))
        dp.maintenance_tick(now=t)
        rec.add(f"tick t={t}", {**stats_rec(dp), "tenants": dp.tenant_stats()})
        t += 1
        assert t < 200, dp.reshard_status()
    rec.add("flipped", {**stats_rec(dp, dump_at=t),
                        "tenants": dp.tenant_stats()})
    for i, tid in enumerate(tids):
        rec.add(f"post w{tid}", step_rec(dp.tenant_step(tid, tbs[i], t)))
    rec.add("resync", dp.tenant_reshard_resync(victim, t + 1))
    rec.add("resynced", {**stats_rec(dp), "tenants": dp.tenant_stats()})
    for i, tid in enumerate(tids):
        rec.add(f"resynced w{tid}",
                step_rec(dp.tenant_step(tid, tbs[i], t + 2)))
    rec.add("again", dp.tenant_reshard_resync(victim, t + 3))
    return rec, tids


def _jbatch(b):
    """A port PacketBatch (the tenant batches' form) as the JAX package's."""
    from antrea_tpu.packet import PacketBatch

    return PacketBatch(src_ip=b.src_ip, dst_ip=b.dst_ip, proto=b.proto,
                       src_port=b.src_port, dst_port=b.dst_port)


@pytest.fixture(scope="module")
def jax_walk(world, batch, tenant_clusters, tenant_batches):
    with jax_trace_bucketed():
        return walk_tenant_veto(jax_engine(world), lambda b: b, jps,
                                JFaultPlan, batch, tenant_clusters,
                                tenant_batches)[0]


def test_single_tenant_canary_veto_equals_the_jax_engine(
        world, batch, tenant_clusters, tenant_batches, oracles, jax_walk):
    """One world's forced canary veto latches only that world (journaled
    tenant-rollback then tenant-reshard-veto, before the fleet's cutover;
    no fleet abort) and its resync flips it; record for record equal to
    the JAX engine, every world's classified lanes Oracle-true, the copies
    equal in every world."""
    dp = port_engine(world)
    rec, tids = walk_tenant_veto(dp, tb, port_ps, TFaultPlan, batch,
                                 tenant_clusters, tenant_batches)
    same_records(rec, jax_walk)
    copies_equal(dp, "after the resync")
    log = dict(rec.log)
    victim = tids[1]
    ts = log["flipped"]["tenants"]
    assert ts[victim]["latched"] == 1 and ts[victim]["topology_generation"] == 0
    assert ts[victim]["reshard_vetoes_total"] == 1
    for tid in tids:
        if tid != victim:
            assert ts[tid]["latched"] == 0
            assert ts[tid]["topology_generation"] == 1
    kinds = log["flipped"]["kinds"]
    assert "reshard-abort" not in kinds
    assert (kinds.index("tenant-rollback") < kinds.index("tenant-reshard-veto")
            < kinds.index("reshard-cutover"))
    assert log["resync"]["resynced"] == 1
    assert log["resynced"]["tenants"][victim]["latched"] == 0
    assert log["again"]["reason"] == "fleet-aligned"
    for i, tid in enumerate(tids):
        parity(oracles[i], tenant_batches[i], dp.tenant_step(
            tid, tenant_batches[i], 300), f"w{tid} after the resync")


# ---- the port's own invariants -----------------------------------------------


def _kill_plan(dp, times):
    plan = TFaultPlan(seed=5)
    plan.every("n0.replica_dead", 1, "r1", times=times)
    dp.arm_failover_faults(plan, "n0")
    return plan


def test_quarantine_evacuates_and_readmits_with_live_worlds(
        world, batch, tenant_clusters, tenant_batches, oracles):
    """Quarantine on a tenanted mesh proceeds to a real evacuation shrink
    (every world flips with the fleet) and the certified readmission grows
    back; every world's classified lanes Oracle-true throughout."""
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    tids = tenants(dp, tenant_clusters, port_ps, n=2)
    tbs, ors = tenant_batches[:2], oracles[:2]
    b = tb(batch)
    dp.step(b, 100)
    for i, tid in enumerate(tids):
        dp.tenant_step(tid, tbs[i], 100)
    _kill_plan(dp, 6)
    t, seen_pending = 101, None
    while dp.failover_stats()["phase"] != "evacuated":
        dp.step(b, t)
        step_worlds(dp, tids, tbs, ors, t, "mid-evac")
        fs = dp.failover_stats()
        if fs["phase"] in ("quarantined", "evacuating") and seen_pending is None:
            seen_pending = fs["tenants_pending_evacuation"]
        dp.maintenance_tick(now=t)
        t += 1
        assert t < 300, dp.failover_stats()
    assert seen_pending == sorted(tids)
    assert dp.failover_stats()["tenants_pending_evacuation"] == []
    assert dp._n_data == 1
    for tid in tids:
        assert dp.tenant_stats()[tid]["topology_generation"] == dp._topo_gen
    q = [e for e in dp.flightrecorder_events()
         if e["kind"] == "replica-quarantine" and "tenant" in e]
    assert {e["tenant"] for e in q} == set(tids)
    while dp.failover_stats()["phase"] != "healthy":
        dp.step(b, t)
        step_worlds(dp, tids, tbs, ors, t, "readmit")
        dp.maintenance_tick(now=t)
        t += 1
        assert t < 400, dp.failover_stats()
    assert dp._n_data == 2
    ts = dp.tenant_stats()
    for tid in tids:
        assert ts[tid]["latched"] == 0
        assert ts[tid]["topology_generation"] == dp._topo_gen
    step_worlds(dp, tids, tbs, ors, t, "post-readmit")
    copies_equal(dp, "after the readmission")


def test_evacuation_veto_masks_only_that_world_until_resync(
        world, batch, tenant_clusters, tenant_batches, oracles):
    """A world vetoing the EVACUATION cutover pins its own survivor mask
    and serves masked on its old topology while the fleet and the other
    world shrink; its resync evacuates it for real."""
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    tids = tenants(dp, tenant_clusters, port_ps, n=2)
    tbs, ors = tenant_batches[:2], oracles[:2]
    b = tb(batch)
    dp.step(b, 100)
    for i, tid in enumerate(tids):
        dp.tenant_step(tid, tbs[i], 100)
    _kill_plan(dp, 6)
    vplan = TFaultPlan(seed=9)
    vplan.every(f"n0.tenant_canary.t{tids[0]}", 1, "forced", times=1)
    dp.arm_reshard_faults(vplan, "n0")
    t = 101
    while dp.failover_stats()["phase"] != "evacuated":
        dp.step(b, t)
        step_worlds(dp, tids, tbs, ors, t, "mid-evac")
        dp.maintenance_tick(now=t)
        t += 1
        assert t < 300, dp.failover_stats()
    ts = dp.tenant_stats()
    assert ts[tids[0]]["latched"] == 1 and ts[tids[1]]["latched"] == 0
    fm = dp._tenants.world(tids[0]).fields["_fo_mask"]
    assert fm is not None and int(fm[0]) == 1
    assert dp.failover_stats()["tenants_pending_evacuation"] == [tids[0]]
    step_worlds(dp, tids, tbs, ors, t, "latched-masked")
    res = dp.tenant_reshard_resync(tids[0], t + 1)
    assert res.get("resynced") == 1, res
    assert dp.tenant_stats()[tids[0]]["latched"] == 0
    assert dp.failover_stats()["tenants_pending_evacuation"] == []
    step_worlds(dp, tids, tbs, ors, t + 2, "post-resync")


def test_untenanted_paths_serve_the_same_step(world, batch):
    """The failover plane armed changes no step: the same step meta and
    bitwise equal results; an untenanted resize ends on the step meta a
    fresh engine at the target width has."""
    a, b = port_engine(world), port_engine(world, failover=True)
    assert a._meta_step == b._meta_step
    ra, rb = a.step(tb(batch), 100), b.step(tb(batch), 100)
    for k in ("code", "svc_idx", "dnat_ip", "dnat_port", "est"):
        np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k), k)
    a.reshard_begin(4)
    t = 101
    while a.reshard_status() is not None:
        a.step(tb(batch), t)
        a.maintenance_tick(now=t)
        t += 1
        assert t < 200
    c = port_engine(world, shape=(4, 2))
    assert a._n_data == 4 and a._meta_step == c._meta_step
    assert a._mesh == c._mesh
    rc = c.step(tb(batch), t)
    ra = a.step(tb(batch), t)
    for k in ("code", "svc_idx", "dnat_ip", "dnat_port"):
        np.testing.assert_array_equal(getattr(ra, k), getattr(rc, k), k)
