"""The serving batcher on the PyTorch port (serving/batcher.py in front of
antrea_tpu_torch's TpuflowDatapath and its scalar twin), held to the JAX
package on the CPU.

- The port's batcher decides as the JAX batcher does under the same
  FaultClock: every tick_flush count, ticket, polled lane, flush and
  deadline event, shed count and wait histogram.
- step_tenants on mixed-tenant batches equals the JAX engine's, every
  StepResult field and every world's tables, in the staged unfused, staged
  fused and one-pass modes (padding lanes ride `valid`, B3's mask column 0
  in one-pass mode), and lane for lane the port's own unbatched
  tenant_step.
- The dispatch-signature bound: eager PyTorch compiles nothing per shape,
  so the batcher's bound is on the distinct (tenant rung signature, lane
  count) pairs reaching models/forwarding.pipeline_step_full, recorded by
  wrapping that function: at most rungs x ladder over 64 uneven tenants
  under gen_bursty (tests/test_serving.py's sizes).

Every value is an int32 or u32 word: no tolerance."""

import copy
import dataclasses

import numpy as np
import pytest

from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.dissemination.faults import FaultClock as JClock
from antrea_tpu.simulator import gen_cluster, gen_traffic
from antrea_tpu.simulator.traffic import gen_bursty
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.config import ConfigError
from antrea_tpu_torch.datapath.tenancy import _sub_batch
from antrea_tpu_torch.dissemination.faults import FaultClock as TClock
from antrea_tpu_torch.models import forwarding as tfw
from antrea_tpu_torch.models.pipeline import tree_leaves
from antrea_tpu_torch.serving import ServingBatcher

from test_torch_engine import port_ps, tb
from test_torch_tenancy import same_result, same_tables
import torch_cpu  # noqa: F401  (one torch thread a worker)

QUOTA = 1 << 8
AFFQ = 1 << 6
KW = dict(flow_slots=1 << 10, aff_slots=1 << 8, flightrec_slots=256,
          realization_slots=0, canary_probes=0)
MODES = {"staged": {}, "fused": {"fused": True},
         "onepass": {"fused": True, "prune_budget": 2}}


def batch(cluster, n, seed):
    return gen_traffic(cluster.pod_ips, n, n_flows=max(8, n // 2),
                       seed=seed)


def pair(base, tenant, **kw):
    """The JAX engine and the port's (CPU), each with one tenant world."""
    kw = {**KW, **kw}
    j = JEngine(copy.deepcopy(base.ps), **kw)
    t = td.TpuflowDatapath(port_ps(base.ps), device="cpu", **kw)
    a = j.tenant_create("a", copy.deepcopy(tenant.ps), quota=QUOTA,
                        aff_quota=AFFQ)
    b = t.tenant_create("a", port_ps(tenant.ps), quota=QUOTA,
                        aff_quota=AFFQ)
    assert a == b
    return j, t, a


def events(dp, kinds=("batch-flush", "batch-deadline-exceeded")):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in dp.flightrecorder_events() if e["kind"] in kinds]


def same_batchers(j, t, what):
    sj, st = j.serving_stats(), t.serving_stats()
    assert sj == st, what
    hj, ht = j.serving_plane._wait_hists, t.serving_plane._wait_hists
    assert sorted(hj) == sorted(ht), what
    for tid in hj:
        assert (hj[tid]._counts, hj[tid].sum) == (ht[tid]._counts,
                                                  ht[tid].sum), what
    assert events(j) == events(t), what


def test_batcher_decisions_equal_jax_under_faultclock():
    """The same submits and ticks on both packages' batchers, each on its
    own FaultClock: the deadline flush at the exact tick, a starved flush
    past the deadline, a depth flush, the ring's tail shed, and the forced
    overflow flush decide identically, and the lanes they return equal."""
    base = gen_cluster(6, n_nodes=2, pods_per_node=4, seed=31)
    ten = gen_cluster(8, n_nodes=2, pods_per_node=4, seed=32)
    cj, ct = JClock(start=0), TClock(start=0)
    knobs = dict(serving_batcher=True, canonical_sizes=(8,), flush_depth=8,
                 flush_deadline=3, serving_ring_slots=16)
    j = JEngine(copy.deepcopy(base.ps), maint_clock=cj, **KW, **knobs)
    t = td.TpuflowDatapath(port_ps(base.ps), maint_clock=ct, device="cpu",
                           **KW, **knobs)
    tid = j.tenant_create("a", copy.deepcopy(ten.ps), quota=QUOTA)
    assert t.tenant_create("a", port_ps(ten.ps), quota=QUOTA) == tid
    bj, bt = j.serving_batcher(), t.serving_batcher()
    tickets = []

    def submit(b, now, tenant=0, shed=True):
        a = bj.submit(b, now, tenant=tenant, shed=shed)
        c = bt.submit(tb(b), now, tenant=tenant, shed=shed)
        np.testing.assert_array_equal(c, a)
        tickets.extend(int(x) for x in a if x >= 0)
        return a

    def tick(now, advance=1):
        for _ in range(advance):
            cj.advance()
            ct.advance()
        n = bj.tick_flush(now, budget=4)
        assert bt.tick_flush(now, budget=4) == n
        return n

    submit(batch(base, 3, seed=2), 0.0)
    submit(batch(ten, 2, seed=3), 0.0, tenant=tid)
    assert tick(0.0) == tick(0.0) == 0
    assert tick(0.0) == 2  # both rings reach the deadline at tick 3
    submit(batch(ten, 2, seed=4), 1.0, tenant=tid)
    assert tick(1.0, advance=5) == 1  # starved past the deadline
    submit(batch(base, 8, seed=5), 2.0)
    assert tick(2.0) == 1  # depth-due
    tk = submit(batch(base, 20, seed=6), 3.0)
    assert (tk[16:] == -1).all()  # the ring's tail shed
    submit(batch(ten, 20, seed=7), 3.0, tenant=tid, shed=False)
    bj.flush_all(4.0)
    bt.flush_all(4.0)
    for k in tickets:
        a, b = bj.poll(k), bt.poll(k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a == b, k
    same_batchers(j, t, "faultclock")
    st = t.serving_stats()
    assert st["shed_lanes"] == 4 and st["deadline_exceeded"] == 1
    assert st["flushes"]["deadline"] >= 2 and st["flushes"]["depth"] >= 1
    assert st["flushes"]["overflow"] >= 1


@pytest.mark.parametrize("mode", list(MODES))
def test_step_tenants_equal_jax_engine(mode):
    """A bursty two-tenant schedule (the default world and one tenant)
    through step_tenants on both engines: every StepResult field, both
    worlds' tables, tenant_dump_flows() and the batcher's counters are
    equal, and the padding lanes never reach a table."""
    c0 = gen_cluster(8, n_nodes=2, pods_per_node=8, seed=21)
    c1 = gen_cluster(12, n_nodes=2, pods_per_node=8, seed=22)
    j, t, tid = pair(c0, c1, serving_batcher=True, canonical_sizes=(8, 32),
                     flush_deadline=2, **MODES[mode])
    sched = gen_bursty(c0.pod_ips, 6, tenants=2, burst_lanes=5, seed=29)
    now = 10
    for entry in sched:
        now += 1
        if entry is None:
            continue
        idx, b = entry
        tids = np.where(np.asarray(idx) == 0, 0, tid)
        same_result(j.step_tenants(tids, b, now),
                    t.step_tenants(tids, tb(b), now), f"{mode} @{now}")
    same_tables(j._state, t._state, f"{mode}: default world")
    same_tables(j._tenants.world(tid).fields["_state"],
                t._tenants.world(tid).fields["_state"], f"{mode}: tenant")
    assert j.tenant_dump_flows(tid, now) == t.tenant_dump_flows(tid, now)
    assert j.tenant_stats() == t.tenant_stats()
    same_batchers(j, t, mode)
    st = t.serving_stats()
    assert st["padded_lanes"] > 0 and st["shed_lanes"] == 0
    occupied = t.cache_stats()["occupied"] + t.tenant_stats()[tid]["occupied"]
    assert occupied <= st["flushed_lanes"] * 2


def _as_rows(res):
    return list(zip(np.asarray(res.code).tolist(),
                    np.asarray(res.est).tolist(),
                    np.asarray(res.committed).tolist(),
                    list(res.ingress_rule), list(res.egress_rule)))


@pytest.mark.parametrize("which", ["engine", "twin"])
def test_step_tenants_lane_exact_vs_unbatched(which):
    """step_tenants returns, lane for lane, what unbatched per-tenant
    dispatch returns, and n_miss sums once per dispatch (padding lanes
    never count), on the port's engine and on its twin."""
    cls, dev = ((td.TpuflowDatapath, {"device": "cpu"}) if which == "engine"
                else (td.OracleDatapath, {}))
    c0 = gen_cluster(8, n_nodes=2, pods_per_node=8, seed=11)
    c1 = gen_cluster(14, n_nodes=2, pods_per_node=8, seed=12)

    def mk():
        dp = cls(port_ps(c0.ps), serving_batcher=True,
                 canonical_sizes=(8, 32), flush_deadline=2, **KW, **dev)
        return dp, dp.tenant_create("a", port_ps(c1.ps), quota=QUOTA,
                                    aff_quota=AFFQ)

    (dp_b, t_b), (dp_u, t_u) = mk(), mk()
    b = tb(batch(c0, 24, seed=5))
    lane_tids = np.asarray([0, t_b] * 12)
    for now in (1, 2):
        res = dp_b.step_tenants(lane_tids, b, now)
        rows, n_miss = [None] * 24, 0
        for tid in (0, t_u):
            sel = np.nonzero(lane_tids == tid)[0]
            sub = _sub_batch(b, sel)
            r = (dp_u.step(sub, now) if tid == 0
                 else dp_u.tenant_step(tid, sub, now))
            n_miss += int(r.n_miss)
            for lane, row in zip(sel, _as_rows(r)):
                rows[int(lane)] = row
        assert _as_rows(res) == rows
        assert int(res.n_miss) == n_miss


def test_dispatch_signatures_bounded_by_rungs_times_ladder(monkeypatch):
    """64 tenants on 4 rung shapes, trickling bursty arrivals: the distinct
    (rung signature, lane count) pairs reaching pipeline_step_full stay at
    or under rungs x len(canonical_sizes); without the ladder every lane
    count would be its own dispatch shape."""
    shapes = [gen_cluster(n, n_nodes=2, pods_per_node=8, seed=s)
              for n, s in ((6, 1), (20, 2), (45, 3), (100, 4))]
    ladder = (8, 32)
    dp = td.TpuflowDatapath(device="cpu", serving_batcher=True,
                            canonical_sizes=ladder, flush_deadline=2,
                            **{**KW, "flightrec_slots": 0})
    tids = [dp.tenant_create(f"t{i}", port_ps(shapes[i % 4].ps),
                             quota=QUOTA, aff_quota=AFFQ)
            for i in range(64)]
    rungs = dp.tenant_rungs()
    assert dp.tenant_count == 64 and len(rungs) == 4
    sigs = []
    real = tfw.pipeline_step_full

    def recording(state, drs, *args, meta, **kw):
        sigs.append(((meta, tuple(tuple(x.shape) for x in tree_leaves(drs)),
                      tuple(tuple(x.shape) for x in tree_leaves(state))),
                     int(args[2].shape[0])))
        return real(state, drs, *args, meta=meta, **kw)

    monkeypatch.setattr(tfw, "pipeline_step_full", recording)
    sched = gen_bursty(shapes[0].pod_ips, 10, tenants=64, burst_lanes=6,
                       seed=17)
    served, now = 0, 100
    for entry in sched:
        now += 1
        if entry is None:
            continue
        idx, b = entry
        res = dp.step_tenants(np.asarray([tids[int(i)] for i in idx]),
                              tb(b), now)
        served += int(np.asarray(res.code).shape[0])
    assert served == sum(e[0].size for e in sched if e is not None)
    distinct = set(sigs)
    assert {s for s, _ in distinct} <= rungs
    assert {n for _, n in distinct} <= set(ladder)
    assert 0 < len(distinct) <= len(rungs) * len(ladder), distinct
    assert len(sigs) > len(distinct)  # signatures are shared, not per call
    st = dp.serving_stats()
    assert st["submitted_lanes"] == served and st["shed_lanes"] == 0


def test_deadline_flush_at_exact_faultclock_tick():
    clk = TClock(start=0)
    c = gen_cluster(6, n_nodes=2, pods_per_node=4, seed=31)
    dp = td.TpuflowDatapath(port_ps(c.ps), device="cpu", maint_clock=clk,
                            serving_batcher=True, canonical_sizes=(8,),
                            flush_deadline=3, **KW)
    b = dp.serving_batcher()
    assert "serving-flush" in dp.maintenance.task_names
    tickets = b.submit(tb(batch(c, 3, seed=2)), 0.0)
    for _ in range(2):
        clk.advance()
        assert b.tick_flush(0.0, budget=4) == 0
        assert all(b.poll(int(k)) is None for k in tickets)
        assert dp.serving_stats()["staged_lanes"] == 3
    clk.advance()
    assert b.tick_flush(0.0, budget=4) == 1
    assert all(b.poll(int(k)) is not None for k in tickets)
    ev = dp._flightrec.events(kind="batch-flush")
    assert ev[-1]["reason"] == "deadline" and ev[-1]["age_ticks"] == 3
    assert dp._flightrec.events(kind="batch-deadline-exceeded") == []
    assert dp.serving_stats()["flushes"]["deadline"] == 1


def test_depth_flush_and_ring_overflow_shed():
    c = gen_cluster(6, n_nodes=2, pods_per_node=4, seed=33)
    dp = td.TpuflowDatapath(port_ps(c.ps), device="cpu",
                            serving_batcher=True, canonical_sizes=(8,),
                            flush_depth=8, serving_ring_slots=16,
                            flush_deadline=64, **KW)
    b = dp.serving_batcher()
    b.submit(tb(batch(c, 8, seed=4)), 1.0)
    assert b.tick_flush(1.0, budget=4) == 1
    st = dp.serving_stats()
    assert st["flushes"]["depth"] == 1 and st["staged_lanes"] == 0
    tk = b.submit(tb(batch(c, 20, seed=5)), 2.0)
    assert (tk[:16] >= 0).all() and (tk[16:] == -1).all()
    assert dp.serving_stats()["shed_lanes"] == 4
    tk2 = b.submit(tb(batch(c, 20, seed=6)), 3.0, shed=False)
    assert (tk2 >= 0).all()
    assert dp.serving_stats()["flushes"]["overflow"] >= 1


def test_batcher_config_rejections():
    dummy = object()
    for kw in ({"canonical_sizes": ()}, {"canonical_sizes": (8, 24)},
               {"canonical_sizes": (32, 8)}, {"canonical_sizes": (8, 8)},
               {"flush_depth": 0}, {"flush_deadline": 0},
               {"canonical_sizes": (8,), "flush_depth": 8, "ring_slots": 4}):
        with pytest.raises(ConfigError):
            ServingBatcher(dummy, **kw)
    c = gen_cluster(6, n_nodes=2, pods_per_node=4, seed=41)
    dp = td.TpuflowDatapath(port_ps(c.ps), device="cpu",
                            serving_batcher=True, canonical_sizes=(8,), **KW)
    with pytest.raises(KeyError):
        dp.serving_batcher().submit(tb(batch(c, 4, seed=1)), 0.0, tenant=99)


def test_step_unchanged_with_batcher_configured():
    """step() with the batcher configured returns what the batcher-less
    engine returns and leaves the same tables (valid=None)."""
    c = gen_cluster(10, n_nodes=2, pods_per_node=8, seed=51)
    b = tb(batch(c, 32, seed=7))
    off = td.TpuflowDatapath(port_ps(c.ps), device="cpu", **KW)
    on = td.TpuflowDatapath(port_ps(c.ps), device="cpu", serving_batcher=True,
                            canonical_sizes=(8, 32), **KW)
    r_off, r_on = off.step(b, 1), on.step(b, 1)
    for f in dataclasses.fields(r_off):
        x, y = getattr(r_off, f.name), getattr(r_on, f.name)
        assert (x is None and y is None) or np.array_equal(
            np.asarray(x, dtype=object), np.asarray(y, dtype=object)), f.name
    for x, y in zip(tree_leaves(off._state), tree_leaves(on._state)):
        assert x.numpy().tobytes() == y.numpy().tobytes()
