"""The PyTorch port's resize and failover with eight live tenant worlds
on the CPU, the eight-world analogues of tests/test_tenant_reshard.py: a
grow and a shrink with a newborn world adopted mid-flight, and a replica
kill under SYN flood through quarantine, evacuation and readmission.
Every classified lane of every world is held to the port's scalar Oracle
on the world's policy at every tick, as the JAX tests hold theirs.  The
worlds and helpers are tests/test_torch_tenant_reshard.py's (which holds
the single-world veto walk bit for bit to the JAX engine)."""

import numpy as np

from antrea_tpu.simulator.genpolicy import gen_cluster
from antrea_tpu.simulator.traffic import gen_syn_flood, gen_traffic
from antrea_tpu_torch.observability.metrics import render_metrics
from antrea_tpu_torch.oracle.interpreter import Oracle as TOracle

from test_torch_engine import port_ps, tb
from test_torch_reshard import copies_equal, port_engine
from test_torch_tenant_reshard import (  # noqa: F401
    FO_KW, N_WORLDS, _kill_plan, batch, oracles, parity,
    resize_under_traffic, step_worlds, tenant_batches, tenant_clusters,
    tenants, world)
import torch_cpu  # noqa: F401  (one torch thread a worker)


def test_grow_and_shrink_with_eight_live_tenant_worlds(
        world, batch, tenant_clusters, tenant_batches, oracles):
    """Grow 2 -> 4 and shrink 4 -> 2 with eight live worlds (async, the
    shared queue drained empty first) and a newborn world adopted mid
    shrink: every world's classified lanes Oracle-true every tick, each
    world flipped and serving from its migrated cache, no veto."""
    dp = port_engine(world, async_slowpath=True, miss_queue_slots=1 << 10,
                     drain_batch=128)
    tids = tenants(dp, tenant_clusters, port_ps)
    tbs, ors = list(tenant_batches), list(oracles)
    b = tb(batch)
    dp.step(b, 100)
    for i, tid in enumerate(tids):
        dp.tenant_step(tid, tbs[i], 100)
    for k in range(8):
        dp.drain_slowpath(101 + k)
    est_before = {}
    for i, tid in enumerate(tids):
        r = dp.tenant_step(tid, tbs[i], 110)
        parity(ors[i], tbs[i], r, f"pre w{tid}")
        est_before[tid] = np.asarray(r.est).astype(bool)
        assert est_before[tid].any(), tid
    dp.reshard_begin(4)
    t = resize_under_traffic(dp, b, tids, tbs, ors, 111)
    assert (dp._n_data, dp._topo_gen) == (4, 1)
    st = dp.reshard_stats()
    assert st["tenant_rows_total"] > 0 and st["tenant_vetoes_total"] == 0
    ts = dp.tenant_stats()
    for tid in tids:
        assert ts[tid]["latched"] == 0 and ts[tid]["topology_generation"] == 1
        assert ts[tid]["reshard_rows_total"] > 0
    kept = total = 0
    for i, tid in enumerate(tids):
        r = dp.tenant_step(tid, tbs[i], t)
        parity(ors[i], tbs[i], r, f"post-grow w{tid}")
        est = np.asarray(r.est).astype(bool)
        kept += int(est[est_before[tid]].sum())
        total += int(est_before[tid].sum())
    assert kept / total > 0.85, (kept, total)
    dp.reshard_begin(2)
    nc = gen_cluster(20, n_nodes=2, pods_per_node=5, seed=777)
    tids.append(dp.tenant_create("newborn", port_ps(nc.ps), quota=64))
    tbs.append(tb(gen_traffic(nc.pod_ips, 64, n_flows=24, seed=88)))
    ors.append(TOracle(port_ps(nc.ps)))
    t = resize_under_traffic(dp, b, tids, tbs, ors, t)
    assert (dp._n_data, dp._topo_gen) == (2, 2)
    ts = dp.tenant_stats()
    for tid in tids:
        assert ts[tid]["latched"] == 0 and ts[tid]["topology_generation"] == 2
    step_worlds(dp, tids, tbs, ors, t, "post-shrink")
    copies_equal(dp, "after the shrink")
    kinds = [e["kind"] for e in dp.flightrecorder_events()]
    assert kinds.count("reshard-cutover") == 2
    assert kinds.count("tenant-reshard-cutover") == 2 * N_WORLDS + 1
    for k in ("tenant-reshard-veto", "tenant-rollback", "reshard-abort"):
        assert k not in kinds
    text = render_metrics(dp, node="n0")
    for fam in ("antrea_tpu_reshard_tenant_rows_total",
                "antrea_tpu_tenant_topology_generation",
                "antrea_tpu_tenant_latched"):
        assert fam in text, fam



def test_chaos_soak_replica_kill_under_syn_flood_eight_worlds(
        world, tenant_clusters, tenant_batches, oracles):
    """A replica kill under eight live worlds with SYN-flood and steady
    traffic through quarantine, evacuation and readmission: no world's
    classified lane ever disagrees with the Oracle, the journal carries
    the whole arc, and once the re-miss burst drains every world's
    established set serves from cache again."""
    cluster, services = world
    dp = port_engine(world, failover=True, failover_knobs=FO_KW,
                     async_slowpath=True, miss_queue_slots=1 << 10,
                     drain_batch=128)
    tids = tenants(dp, tenant_clusters, port_ps)
    tbs, ors = tenant_batches, oracles
    steady = tb(gen_traffic(cluster.pod_ips, 64, n_flows=32, seed=3,
                            services=services, svc_fraction=0.3))
    dp.step(steady, 100)
    for i, tid in enumerate(tids):
        dp.tenant_step(tid, tbs[i], 100)
    for k in range(8):
        dp.drain_slowpath(101 + k)
    est_before = {tid: np.asarray(dp.tenant_step(tid, tbs[i], 110).est)
                  .astype(bool) for i, tid in enumerate(tids)}
    _kill_plan(dp, 40)
    t, seq, phases = 111, 0, set()
    while True:
        if t % 2:
            dp.step(tb(gen_syn_flood(cluster.pod_ips, 64, start_seq=seq)), t)
            seq += 64
        else:
            dp.step(steady, t)
        step_worlds(dp, tids, tbs, ors, t, "soak")
        phases.add(dp.failover_stats()["phase"])
        dp.maintenance_tick(now=t)
        t += 1
        if dp.failover_stats()["phase"] == "healthy":
            kinds = {e["kind"] for e in dp.flightrecorder_events()}
            if {"replica-quarantine", "replica-evacuate",
                    "replica-readmit"} <= kinds:
                break
        assert t < 600, (dp.failover_stats(), sorted(phases))
    assert phases - {"healthy"}
    assert dp._n_data == 2
    for _ in range(3):
        for i, tid in enumerate(tids):
            dp.tenant_step(tid, tbs[i], t)
        for k in range(8):
            dp.drain_slowpath(t)
            t += 1
    kept = total = 0
    for i, tid in enumerate(tids):
        r = dp.tenant_step(tid, tbs[i], t)
        parity(ors[i], tbs[i], r, f"post-soak w{tid}")
        est = np.asarray(r.est).astype(bool)
        assert est.any(), tid
        kept += int(est[est_before[tid]].sum())
        total += int(est_before[tid].sum())
    assert kept / total > 0.85, (kept, total)
    assert "tenant-reshard-veto" not in [
        e["kind"] for e in dp.flightrecorder_events()]
