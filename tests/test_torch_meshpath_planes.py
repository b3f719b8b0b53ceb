"""The PyTorch port's mesh engine against the JAX package's MeshDatapath on
the CPU, plane by plane: the per-replica slow path and the mesh-wide epoch
swap, the replica-resolved canary (its per-replica codes, the veto, the
journal chain), the striped audit, the observability surfaces, tenant
worlds and the refusals.  The world and knobs are
tests/test_mesh_datapath.py's; tests/test_torch_reshard.py and
tests/test_torch_failover.py hold the resize and failover planes; every value compared is an int32 word or a
host count, so the tolerance is exact equality.  The helpers are
tests/test_torch_meshpath.py's."""

import numpy as np
import pytest

from antrea_tpu.config import ConfigError as JConfigError
from antrea_tpu.datapath.commit import CanaryMismatchError as JMismatch
from antrea_tpu.parallel import mesh as jpm
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu.simulator.traffic import gen_traffic
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.config import ConfigError as TConfigError
from antrea_tpu_torch.datapath import CanaryMismatchError as TMismatch
from antrea_tpu_torch.observability.metrics import render_metrics
from antrea_tpu_torch.parallel import MeshDatapath as TMesh
from antrea_tpu_torch.utils import ip as tip

from test_torch_engine import port_ps, port_svcs, tb
from test_torch_meshpath import (KW, batch, engines, meshes,  # noqa: F401
                                 same_result, same_slowpath_stats,
                                 same_state, same_surfaces, world)

ASYNC = dict(async_slowpath=True, miss_queue_slots=1 << 12, drain_batch=256)


def same_queue(j, t, what):
    assert t.dump_miss_queue() == j.dump_miss_queue(), what
    same_slowpath_stats(j, t, what)


def journal(dp, kind):
    """The flight recorder's events of a kind, without their clocks."""
    return [{k: v for k, v in e.items() if k not in ("ts", "seq", "wall")}
            for e in dp.flightrecorder_events(kind=kind)]


# ---- the per-replica slow path ----------------------------------------------


def test_async_mesh_drain_and_mesh_wide_epoch_swap(world, meshes, batch):
    """Every miss admitted to its home replica's queue, one drain over every
    replica, one epoch bump journaled as mesh-epoch-swap; the queues, the
    drain, the journal and the next step bitwise equal to the JAX engine."""
    j, t = engines(world, meshes, **ASYNC)
    rj, rt = j.step(batch, 100), t.step(tb(batch), 100)
    same_result(rj, rt, "fast step")
    same_queue(j, t, "admitted")
    sp0 = t.slowpath_stats()
    assert int(rt.pending.sum()) == sum(sp0["replica_depths"])
    assert all(d > 0 for d in sp0["replica_depths"])
    dj, dt = j.drain_slowpath(101), t.drain_slowpath(101)
    assert dt == dj and dt["drained"] == sum(sp0["replica_depths"])
    assert t.slowpath_stats()["epoch"] == sp0["epoch"] + 1
    swaps = journal(t, "mesh-epoch-swap")
    assert swaps == journal(j, "mesh-epoch-swap") and swaps[-1]["replicas"] == 2
    rj, rt = j.step(batch, 102), t.step(tb(batch), 102)
    same_result(rj, rt, "after the drain")
    assert int(rt.est.sum()) > 0
    same_queue(j, t, "after the drain")
    same_surfaces(j, t, 103, "drained")
    # The per-replica epoch scans: a new generation, then time past the
    # denials' and SYN entries' lifetimes.
    for dp in (j, t):
        dp._gen += 1
    assert t._epoch_revalidate() == j._epoch_revalidate() > 0
    assert t._epoch_age_scan(200) == j._epoch_age_scan(200)
    late = 103 + 2 * 3600
    got = t._epoch_maintain(late)
    assert got == j._epoch_maintain(late) and got[0] > 0
    same_state(j, t, "scanned")


def test_mesh_drain_with_oversized_explicit_pop_stays_home(world, meshes):
    """begin_drain(n) with n > drain_batch widens each replica's lane slice
    to n: every committed entry sits in its home replica's table, as on
    the JAX engine, table for table."""
    cluster, _ = world
    j, t = engines(world, meshes, **dict(ASYNC, drain_batch=128))
    tr = gen_traffic(cluster.pod_ips, 512, n_flows=256, seed=29)
    for dp, b in ((j, tr), (t, tb(tr))):
        dp.step(b, 100)
        assert dp._slowpath.begin_drain(101, n=512)
        out = dp._slowpath.finish_drain(102)
        assert out["drained"] > 128
    for d, row in enumerate(t._state):
        for e in t._dump_flows_state(row[0], 103):
            home = jpm.shard_of_tuples(
                np.array([tip.ip_to_key(e["src"])], np.uint32),
                np.array([tip.ip_to_key(e["dst"])], np.uint32),
                np.array([e["proto"]]), np.array([e["sport"]]),
                np.array([e["dport"]]), 2)[0]
            assert home == d, (d, e)
    same_queue(j, t, "oversized pop")
    same_surfaces(j, t, 103, "oversized pop")


def test_mesh_epoch_swap_mid_drain_reclassifies_stale(world, meshes):
    """A bundle landing between begin_drain and finish_drain makes the
    in-flight blocks stale: they re-classify under the new tables on
    every replica, and re-missed flows re-enqueue idempotently; bitwise
    equal to the JAX engine throughout."""
    cluster, services = world
    j, t = engines(world, meshes, **ASYNC)
    tr = gen_traffic(cluster.pod_ips, 256, n_flows=64, seed=21)
    outs = []
    for dp, b, ps, svcs in ((j, tr, cluster.ps, services),
                            (t, tb(tr), port_ps(cluster.ps),
                             port_svcs(services))):
        dp.step(b, 100)
        assert dp._slowpath.begin_drain(101)
        dp.install_bundle(ps, svcs)
        outs.append(dp._slowpath.finish_drain(102))
        dp.step(b, 103)
        dp.drain_slowpath(104)
    assert outs[1] == outs[0]
    assert outs[1]["stale_reclassified"] == outs[1]["drained"] > 0
    same_result(j.step(tr, 105), t.step(tb(tr), 105), "after the swap")
    same_queue(j, t, "after the swap")
    same_surfaces(j, t, 106, "after the swap")


# ---- the replica-resolved canary --------------------------------------------


def test_replica_canary_veto_rolls_back_all_replicas(world, meshes):
    """corrupt_replica(1) flips replica 1's copies alone: the canary's
    per-replica codes equal the JAX engine's (replica 0 clean, replica 1
    diverged), a services-only install is vetoed by replica 1, the
    generation stays, the engine degrades; a full bundle recovers."""
    cluster, services = world
    j, t = engines(world, meshes)
    assert "replica 1" in t.corrupt_replica(1)
    j.corrupt_replica(1)
    probes = gen_traffic(cluster.pod_ips, 64, n_flows=64, seed=41)
    cj = j._canary_classify(probes, 0)
    ct = t._canary_classify(tb(probes), 0)
    assert ct.shape == cj.shape == (2, 64)
    np.testing.assert_array_equal(ct, cj)
    assert (ct[0] != ct[1]).any()
    gen0 = t.generation
    svcs2 = gen_services(8, cluster.pod_ips, seed=12)
    with pytest.raises(JMismatch) as ej:
        j.install_bundle(None, svcs2)
    with pytest.raises(TMismatch) as et:
        t.install_bundle(None, port_svcs(svcs2))
    assert sorted({m["replica"] for m in et.value.mismatches}) == [1]
    assert et.value.mismatches == ej.value.mismatches
    assert t.generation == gen0 and t.degraded and j.degraded
    assert t.commit_stats()["replica_mismatches"] == \
        j.commit_stats()["replica_mismatches"]
    assert t.mesh_stats() == j.mesh_stats()
    j.install_bundle(cluster.ps, services)
    t.install_bundle(port_ps(cluster.ps), port_svcs(services))
    assert not t.degraded
    np.testing.assert_array_equal(t._canary_classify(tb(probes), 0),
                                  j._canary_classify(probes, 0))


def test_replica_veto_watchdog_chain_in_journal(world, meshes):
    """The watchdog catches replica 0's corruption between installs: the
    scan, the replica mismatch counts and the journal chain
    replica-canary-veto -> degrade -> recover (the scheduler's
    degraded-recompile) equal the JAX engine's."""
    j, t = engines(world, meshes)
    scans = []
    for dp in (j, t):
        dp.corrupt_replica(0)
        scans.append(dp.canary_scan(recover=False))
    assert scans[1] == scans[0]
    assert scans[1]["mismatches"] > 0 and scans[1]["degraded"]
    assert t.commit_stats()["replica_mismatches"] == \
        j.commit_stats()["replica_mismatches"]
    ticks = [dp.maintenance_tick(now=100)["ran"] for dp in (j, t)]
    assert ticks[1] == ticks[0] and ticks[1].get("degraded-recompile") == 1
    assert not t.degraded
    kinds = [e["kind"] for e in t.flightrecorder_events()]
    chain = [k for k in kinds
             if k in ("replica-canary-veto", "degrade", "recover")]
    assert chain == ["replica-canary-veto", "degrade", "recover"], kinds
    assert journal(t, "replica-canary-veto") == \
        journal(j, "replica-canary-veto")


# ---- the striped audit ------------------------------------------------------


def test_striped_audit_detects_and_repairs_replica_corruption(world, meshes,
                                                              batch):
    """One replica's cached verdict bit flipped: a window's rows (global
    slots striped over the replicas) equal the JAX engine's, and the forced
    sweep detects and repairs it on the same replica and slot, covering
    every replica's slice; verdicts reconverge and a second sweep is
    clean."""
    j, t = engines(world, meshes)
    j.step(batch, 100)
    t.step(tb(batch), 100)
    assert t._audit_window(5, 300, 100) == j._audit_window(5, 300, 100)
    desc = t._audit_corrupt("verdict", now=101)
    assert "replica" in desc and desc == j._audit_corrupt("verdict", now=101)
    outs = [dp.maintenance_force_audit(now=101) for dp in (j, t)]
    assert outs[1] == outs[0]
    assert outs[1]["divergences"] >= 1 and outs[1]["repaired"] >= 1
    assert outs[1]["scanned"] == 2 * KW["flow_slots"]
    ms = t.mesh_stats()
    assert ms == j.mesh_stats()
    assert all(n > 0 for n in ms["replica_audit_entries"]), ms
    same_result(j.step(batch, 102), t.step(tb(batch), 102), "repaired")
    outs = [dp.maintenance_force_audit(now=103) for dp in (j, t)]
    assert outs[1] == outs[0] and outs[1]["divergences"] == 0
    same_surfaces(j, t, 104, "audited")


# ---- surfaces, tenancy, refusals --------------------------------------------


def test_mesh_observability_surfaces(world, meshes, batch):
    """The replica-labeled metric families, mesh_stats(), the queue dump
    behind dump_miss_queue(), the reshard and failover schemas with no
    plane, and trace() routed per home replica, equal to the JAX engine."""
    j, t = engines(world, meshes, **dict(ASYNC, miss_queue_slots=1 << 10))
    j.step(batch, 100)
    t.step(tb(batch), 100)
    text = render_metrics(t, node="n0")
    for fam in ("antrea_tpu_replica_miss_queue_depth",
                "antrea_tpu_replica_canary_mismatches_total",
                "antrea_tpu_replica_audit_entries_total"):
        for r in (0, 1):
            assert f'{fam}{{replica="{r}",node="n0"}}' in text, fam
    ms = t.mesh_stats()
    assert ms == j.mesh_stats()
    assert ms["mesh"] == {"data": 2, "rule": 2} and ms["devices"] == 4
    assert len(t.dump_miss_queue()) == sum(ms["replica_miss_queue_depth"])
    same_queue(j, t, "surfaces")
    assert t.reshard_stats() == j.reshard_stats()
    assert t.failover_stats() == j.failover_stats()
    sub16 = gen_traffic(world[0].pod_ips, 16, n_flows=16, seed=5)
    assert t.trace(tb(sub16), 101) == j.trace(sub16, 101)
    assert td.TpuflowDatapath(None, None, device="cpu", **KW).commit_stats()[
        "replica_mismatches"] == {}


def test_mesh_tenant_world_serves_on_every_replica(world, meshes, batch):
    """A tenant world on the mesh: its rung-padded grid and per-replica
    state, step_tenants lane for lane equal to tenant_step, its verdicts
    equal to the port's single-card engine with the same world, its
    occupancy the replicas' sum (which lanes collide is the cache
    topology's: two private tables are not one)."""
    cluster, services = world
    t = TMesh(port_ps(cluster.ps), port_svcs(services), n_data=2, n_rule=2,
              device="cpu", **KW)
    s = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu", **KW)
    tids = [dp.tenant_create("a", port_ps(cluster.ps), quota=1 << 8,
                             aff_quota=1 << 6) for dp in (t, s)]
    assert tids[0] == tids[1]
    b = tb(batch)
    for k in range(2):
        rt = t.tenant_step(tids[0], b, 100 + k)
        rs = s.tenant_step(tids[1], b, 100 + k)
        for f in ("code", "svc_idx", "dnat_ip", "dnat_port"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rs, f))
        assert rt.ingress_rule == rs.ingress_rule
    w = t._tenants.world(tids[0]).fields
    assert len(w["_state"]) == 2 and len(w["_state"][0]) == 2
    st = t.tenant_stats()[tids[0]]
    assert st["occupied"] == sum(
        int((row[0].flow.keys[:-1, -1] != 0).sum()) for row in w["_state"])
    assert st["occupied"] > 0
    assert st["topology_generation"] == 0 and st["latched"] == 0


def test_mesh_refusals(world, meshes):
    """The JAX ConfigErrors word for word, a batch that does not split
    over the data axis, profile(), and the resize and failover refusals
    of the JAX engine, word for word: no resize to abort, the plane not
    enabled, a size equal to the current one, a pool too small, a second
    resize in flight, a resize on a degraded engine."""
    cases = [dict(dual_stack=True),
             dict(async_slowpath=True, overlap_commits=True),
             dict(async_slowpath=True, autotune_drain=True),
             dict(reshard_budget=0)]
    for extra in cases:
        with pytest.raises(JConfigError) as ej:
            engines(world, meshes, **extra)
        with pytest.raises(TConfigError) as et:
            TMesh(None, None, n_data=2, n_rule=2, device="cpu", **KW,
                  **extra)
        assert str(et.value) == str(ej.value), extra
    cluster, _ = world
    t = TMesh(port_ps(cluster.ps), None, n_data=2, n_rule=2, device="cpu",
              **KW)
    with pytest.raises(ValueError, match="not divisible"):
        t.step(tb(gen_traffic(cluster.pod_ips, 7, n_flows=7, seed=2)), 100)
    with pytest.raises(NotImplementedError, match="single-chip surface"):
        t.profile(None)
    assert t.arm_failover_faults(None, "x") is None  # no plane: a no-op
    assert t.reshard_status() is None and t._maint_reshard(0, 1) == 0
    assert t._maint_replica_health(0, 1) == 0

    def same_refusal(j, t, call, want):
        with pytest.raises((RuntimeError, ValueError)) as ej:
            call(j)
        with pytest.raises(type(ej.value)) as et:
            call(t)
        assert str(et.value) == str(ej.value)
        assert want in str(et.value)

    j, t = engines(world, meshes)
    same_refusal(j, t, lambda dp: dp.reshard_abort(), "no reshard in flight")
    same_refusal(j, t, lambda dp: dp.failover_readmit(),
                 "the failover plane is not enabled (failover=True)")
    same_refusal(j, t, lambda dp: dp.reshard_begin(2), "equals the current")
    same_refusal(j, t, lambda dp: dp.reshard_begin(64),
                 "need 128 devices, have 8")
    for dp in (j, t):
        dp.reshard_begin(4)
    same_refusal(j, t, lambda dp: dp.reshard_begin(4), "already in flight")
    same_refusal(j, t, lambda dp: dp.tenant_reshard_resync(1, 0),
                 "a reshard is in flight")
    for dp in (j, t):
        dp.reshard_abort("refusals pinned")
        dp.corrupt_replica(1)
    svcs2 = gen_services(8, cluster.pod_ips, seed=12)
    with pytest.raises(JMismatch):
        j.install_bundle(None, svcs2)
    with pytest.raises(TMismatch):
        t.install_bundle(None, port_svcs(svcs2))
    assert j.degraded and t.degraded
    same_refusal(j, t, lambda dp: dp.reshard_begin(4), "degraded")
