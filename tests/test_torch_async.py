"""The PyTorch port's async slow path (datapath/slowpath through the port's
TpuflowDatapath) against the JAX package's engine, on the CPU: the same
worlds, packets and drains through both engines, in the staged fused and
the one-pass modes.  Every value is an int32 or u32 word, so the tolerance
is exact equality: step results (pending lanes included), drain results,
slowpath_stats(), cache_stats(), the rule counters and the flow-cache and
affinity tables (the dump row excluded).  The JAX side runs its Pallas
kernels in interpret mode, as its own tests do.

Each test is the analogue of one in tests/test_slowpath_async.py, held to
the JAX engine where that test holds its engine to the scalar oracle.
Fresh 5-tuples come from one monotonic source-port counter."""

import copy
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from antrea_tpu.apis import controlplane as cp
from antrea_tpu.apis.service import Endpoint, ServiceEntry
from antrea_tpu.compiler.ir import PolicySet
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.datapath.slowpath import engine as jengine
from antrea_tpu.dissemination.faults import FaultPlan as JFaultPlan
from antrea_tpu.packet import Packet, PacketBatch
from antrea_tpu.simulator.traffic import gen_syn_flood
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.config import ConfigError
from antrea_tpu_torch.datapath.slowpath import engine as tengine
from antrea_tpu_torch.dissemination.faults import FaultPlan as TFaultPlan
from antrea_tpu_torch.models.pipeline import PH_ALL

from test_torch_engine import _FIELDS, port_ps, port_svcs, same_state, tb

CLIENT, CLIENT2, SRV = "10.0.1.1", "10.0.1.2", "10.0.0.10"
BLOCKED = "10.0.9.9"
MODES = {"staged": {"fused": True},
         "onepass": {"fused": True, "prune_budget": 2}}
_NOW = itertools.count(1000)
_SPORT = itertools.count(20000)


@pytest.fixture(autouse=True)
def one_salt(monkeypatch):
    """Both packages draw their early-drop salt from os.urandom once per
    process: parity under shedding needs one value in both."""
    salt = np.uint32(0x5EED)
    monkeypatch.setattr(jengine, "_EARLY_DROP_SALT", salt)
    monkeypatch.setattr(tengine, "_EARLY_DROP_SALT", salt)


def _fresh_pkt(src, dst, dport=80, proto=6):
    return Packet(src_ip=iputil.ip_to_u32(src), dst_ip=iputil.ip_to_u32(dst),
                  proto=proto, src_port=next(_SPORT), dst_port=dport)


def _drop_policy(uid):
    return cp.NetworkPolicy(
        uid=uid, name=uid, type=cp.NetworkPolicyType.ACNP,
        rules=[cp.NetworkPolicyRule(
            direction=cp.Direction.IN,
            from_peer=cp.NetworkPolicyPeer(address_groups=["blocked"]),
            action=cp.RuleAction.DROP, priority=0)],
        applied_to_groups=["web"], tier_priority=250, priority=1.0)


def _world(blocked_ip=BLOCKED, extra=0):
    """tests/test_slowpath_async.py's world: an ACNP dropping blocked_ip ->
    SRV, and one service in front of SRV.  `extra` policies of their own
    go first, which renumbers p1's rule."""
    pols = [_drop_policy(f"x{i}") for i in range(extra)] + [_drop_policy("p1")]
    ps = PolicySet(
        policies=pols,
        address_groups={"blocked": cp.AddressGroup(
            name="blocked", members=[cp.GroupMember(ip=blocked_ip)])},
        applied_to_groups={"web": cp.AppliedToGroup(
            name="web", members=[cp.GroupMember(ip=SRV)])})
    svcs = [ServiceEntry(cluster_ip="10.96.0.1", port=80, protocol=6,
                         name="web", namespace="default",
                         endpoints=[Endpoint(ip=SRV, port=8080)])]
    return ps, svcs


def _pair(ps, svcs, mode="staged", *, flow_slots=1 << 10, queue=256,
          admission="forward", drain_batch=8, **kw):
    kw = dict(dict(flow_slots=flow_slots, aff_slots=1 << 4, miss_chunk=16,
                   async_slowpath=True, miss_queue_slots=queue,
                   admission=admission, drain_batch=drain_batch,
                   canary_probes=0, **MODES[mode]), **kw)
    return (JEngine(copy.deepcopy(ps), svcs, **kw),
            td.TpuflowDatapath(port_ps(ps), port_svcs(svcs), device="cpu",
                               **kw))


def _same_result(rj, rt, what):
    for f in _FIELDS + ("pending",):
        np.testing.assert_array_equal(np.asarray(getattr(rt, f)),
                                      np.asarray(getattr(rj, f)),
                                      err_msg=f"{what}: {f}")
    assert rt.n_miss == rj.n_miss, what
    assert rt.ingress_rule == rj.ingress_rule, what
    assert rt.egress_rule == rj.egress_rule, what


def _step_both(j, t, pkts, now, batch=None):
    b = batch if batch is not None else PacketBatch.from_packets(pkts)
    rj, rt = j.step(b, now), t.step(tb(b), now)
    _same_result(rj, rt, f"now={now}")
    return rt


def _drain_both(j, t, now):
    sj, st = j.drain_slowpath(now), t.drain_slowpath(now)
    assert sj == st
    return st


def _same(j, t, now, what):
    """Every engine surface of the async plane, and the tables."""
    sj, st = j.slowpath_stats(), t.slowpath_stats()
    hj, ht = sj.pop("drain_hist"), st.pop("drain_hist")
    assert sj == st, what
    assert (hj._counts, hj.sum) == (ht._counts, ht.sum), what
    assert j.cache_stats() == t.cache_stats(), what
    assert dataclasses.asdict(j.stats()) == dataclasses.asdict(t.stats()), what
    assert j.dump_miss_queue() == t.dump_miss_queue(), what
    assert j.dump_flows(now) == t.dump_flows(now), what
    same_state(j, t, what)


@pytest.mark.parametrize("mode", MODES)
def test_async_parity_and_convergence_to_sync_verdicts(mode):
    """Fresh tuples: provisional on admission; after one drain the flows'
    verdicts are a synchronous engine's, on both engines, and the reply
    leg of the service connection est-bypasses.  B1 (staged) or B3
    (one-pass) classifies the drain; the fast step runs no slow path."""
    ps, svcs = _world()
    j, t = _pair(ps, svcs, mode)
    assert t._meta_step.phases == 0 and t._meta.phases == PH_ALL
    sync = td.TpuflowDatapath(port_ps(ps), port_svcs(svcs), device="cpu",
                              flow_slots=1 << 10, aff_slots=1 << 4,
                              miss_chunk=16, canary_probes=0, **MODES[mode])
    probes = [_fresh_pkt(BLOCKED, SRV), _fresh_pkt(CLIENT, SRV),
              _fresh_pkt(CLIENT2, "10.96.0.1")]
    rt = _step_both(j, t, probes, next(_NOW))
    assert list(rt.pending) == [1, 1, 1] and list(rt.code) == [0, 0, 0]
    assert t.slowpath_stats()["depth"] == 3
    assert all(r["queued"] for r in t.trace(
        tb(PacketBatch.from_packets(probes)), next(_NOW)))
    _drain_both(j, t, next(_NOW))
    rt2 = _step_both(j, t, probes, next(_NOW))
    rs = sync.step(tb(PacketBatch.from_packets(probes)), next(_NOW))
    assert list(rt2.pending) == [0, 0, 0]
    assert list(rt2.code) == list(rs.code) == [1, 0, 0]
    assert rt2.ingress_rule == rs.ingress_rule
    assert rt2.dnat_ip[2] == iputil.ip_to_u32(SRV) and rt2.dnat_port[2] == 8080
    reply = Packet(src_ip=iputil.ip_to_u32(SRV), dst_ip=probes[2].src_ip,
                   proto=6, src_port=8080, dst_port=probes[2].src_port)
    rt3 = _step_both(j, t, [reply], next(_NOW))
    assert list(rt3.reply) == [1] and list(rt3.est) == [1]
    _same(j, t, next(_NOW), mode)


@pytest.mark.parametrize("mode", MODES)
def test_oversized_explicit_drain_pop_classifies_whole_block(mode):
    """begin_drain(n > drain_batch) pads the drain up to the next power of
    two and classifies every popped row."""
    ps, svcs = _world()
    j, t = _pair(ps, svcs, mode)
    pkts = [_fresh_pkt(BLOCKED, SRV) for _ in range(24)]
    rt = _step_both(j, t, pkts, 10)
    assert int(rt.pending.sum()) == 24
    for dp in (j, t):
        assert dp._slowpath.begin_drain(11, n=24)
        assert dp._slowpath.finish_drain(11)["drained"] == 24
    rt = _step_both(j, t, pkts, 12)
    assert int(rt.pending.sum()) <= 2
    assert (rt.code[rt.pending == 0] == 1).all()
    _same(j, t, 12, mode)


def test_hold_admission_drops_until_classified():
    ps, svcs = _world()
    j, t = _pair(ps, svcs, admission="hold")
    allowed = _fresh_pkt(CLIENT, SRV)
    rt = _step_both(j, t, [allowed], next(_NOW))
    assert list(rt.code) == [1] and list(rt.pending) == [1]
    assert list(rt.reject_kind) == [0]
    _drain_both(j, t, next(_NOW))
    rt2 = _step_both(j, t, [allowed], next(_NOW))
    assert list(rt2.code) == [0] and list(rt2.pending) == [0]


@pytest.mark.parametrize("mode", MODES)
def test_early_drop_admission_parity_under_syn_flood(mode):
    """admission="drop" under gen_syn_flood: the depth-proportional early
    drop sheds the same lanes on both engines (one salt), every step in
    parity, and nothing sheds below the floor."""
    ps, svcs = _world()
    j, t = _pair(ps, svcs, mode, queue=64, admission="drop")
    dst = [iputil.ip_to_u32(SRV)]
    for rnd in range(6):
        flood = gen_syn_flood(dst, 128, start_seq=128 * rnd)
        _step_both(j, t, None, next(_NOW), batch=flood)
        if rnd % 2 == 1:
            _drain_both(j, t, next(_NOW))
    assert t._slowpath.early_drops_total == j._slowpath.early_drops_total > 0
    _same(j, t, next(_NOW), mode)
    j2, t2 = _pair(ps, svcs, mode, queue=64, admission="drop")
    small = gen_syn_flood(dst, 24, start_seq=10_000)
    _step_both(j2, t2, None, next(_NOW), batch=small)
    assert t2._slowpath.early_drops_total == 0
    with pytest.raises(ValueError, match="drop"):
        _pair(ps, svcs, admission="shed")


def test_source_buckets_shed_the_same_lanes():
    """miss_source_rate/_burst (bench.py's attack floor, 4 tokens/s and a
    burst of 16 per source /24) with second chance: one scanning source
    exhausts its bucket, another keeps admitting, identically on both
    engines; the sheds classify the batch as attack-shed."""
    ps, svcs = _world()
    j, t = _pair(ps, svcs, "onepass", admission="drop", queue=1 << 10,
                 miss_source_rate=4.0, miss_source_burst=16,
                 second_chance=True, telemetry=True)
    scan = [_fresh_pkt(BLOCKED, SRV) for _ in range(48)]
    calm = [_fresh_pkt(CLIENT, SRV) for _ in range(8)]
    for rnd in range(3):
        _step_both(j, t, scan + calm, next(_NOW))
        _drain_both(j, t, next(_NOW))
    sj, st = j.slowpath_stats(), t.slowpath_stats()
    assert st["source_limited_total"] == sj["source_limited_total"] > 0
    assert st["admitted_total"] == sj["admitted_total"] >= 16 + 8
    assert (t.telemetry_stats()["counters"]
            == j.telemetry_stats()["counters"])
    assert "attack-shed" in t.telemetry_stats()["regimes"]["engine"]
    _same(j, t, next(_NOW), "source buckets")


@pytest.mark.parametrize("mode", MODES)
def test_epoch_swap_during_inflight_drain_reclassifies(mode):
    """A bundle landing between begin_drain and finish_drain: the in-flight
    batch classifies under the new tensors, counted as stale-reclassified,
    on both engines."""
    ps, svcs = _world()
    ps2, _ = _world(blocked_ip=CLIENT)
    j, t = _pair(ps, svcs, mode, queue=64)
    probe = _fresh_pkt(CLIENT, SRV)
    _step_both(j, t, [probe], next(_NOW))
    now = next(_NOW)
    for dp, ps_ in ((j, copy.deepcopy(ps2)), (t, port_ps(ps2))):
        assert dp._slowpath.begin_drain(now)
        dp.install_bundle(ps=ps_)
        assert dp._slowpath.finish_drain(now + 1)["stale_reclassified"] == 1
    rt = _step_both(j, t, [probe], next(_NOW))
    assert list(rt.code) == [1]
    _same(j, t, next(_NOW), mode)


def test_churn_established_survives_fresh_reclassifies():
    """A bundle swap: the established flow keeps flowing, a fresh tuple of
    the same pair takes the new verdict, and the next drain's fused
    maintenance reclaims the stale denial."""
    ps, svcs = _world()
    ps2, _ = _world(blocked_ip=CLIENT)
    j, t = _pair(ps, svcs)
    est, denied = _fresh_pkt(CLIENT, SRV), _fresh_pkt(BLOCKED, SRV)
    _step_both(j, t, [est, denied], next(_NOW))
    _drain_both(j, t, next(_NOW))
    rt = _step_both(j, t, [est, denied], next(_NOW))
    assert list(rt.code) == [0, 1] and list(rt.est) == [1, 0]
    j.install_bundle(ps=copy.deepcopy(ps2))
    t.install_bundle(ps=port_ps(ps2))
    assert t.slowpath_stats()["epoch_stale"] == 1
    rt2 = _step_both(j, t, [est], next(_NOW))
    assert list(rt2.code) == [0] and list(rt2.est) == [1]
    fresh = _fresh_pkt(CLIENT, SRV)
    _step_both(j, t, [fresh], next(_NOW))
    assert _drain_both(j, t, next(_NOW))["revalidated"] >= 1
    assert list(_step_both(j, t, [fresh], next(_NOW)).code) == [1]
    _same(j, t, next(_NOW), "churn")


def test_eviction_pressure_with_full_miss_queue():
    """A 16-slot cache and a 4-row queue: overflows, evictions and the
    cache's state in exact parity every round."""
    ps, svcs = _world()
    j, t = _pair(ps, svcs, flow_slots=1 << 4, queue=4, drain_batch=4)
    probes = ([_fresh_pkt(CLIENT, SRV) for _ in range(4)]
              + [_fresh_pkt(CLIENT2, SRV) for _ in range(4)])
    rt = _step_both(j, t, probes, next(_NOW))
    assert list(rt.pending) == [1] * 8
    assert t.slowpath_stats()["overflows_total"] == 4
    for rnd in range(5):
        _drain_both(j, t, next(_NOW))
        _step_both(j, t, probes, next(_NOW))
        _same(j, t, next(_NOW), f"round {rnd}")


def test_age_scan_and_fused_maintain():
    """The aging scan reclaims both legs of an idle connection; the fused
    maintenance pass ages and revalidates in one sweep, the established
    flow untouched (tests/test_slowpath_async.py:330 and :556)."""
    ps, svcs = _world()
    ps2, _ = _world(blocked_ip=CLIENT)
    j, t = _pair(ps, svcs, ct_timeout_s=5)
    early = next(_NOW)
    _step_both(j, t, [_fresh_pkt(CLIENT, SRV)], early)
    _drain_both(j, t, early + 1)
    occ = t.cache_stats()["occupied"]
    assert occ > 0
    assert t._slowpath.age_scan(early + 500) == j._slowpath.age_scan(
        early + 500) == occ
    _same(j, t, early + 500, "aged")
    old = _fresh_pkt(CLIENT, SRV)
    _step_both(j, t, [old], early + 600)
    _drain_both(j, t, early + 601)
    late = early + 900
    denied, keep = _fresh_pkt(BLOCKED, SRV), _fresh_pkt(CLIENT2, SRV)
    _step_both(j, t, [denied, keep], late)
    _drain_both(j, t, late + 1)
    j.install_bundle(ps=copy.deepcopy(ps2))
    t.install_bundle(ps=port_ps(ps2))
    assert t._slowpath.maintain(late + 2) == j._slowpath.maintain(
        late + 2) == (2, 1)
    rt = _step_both(j, t, [keep], late + 3)
    assert list(rt.est) == [1] and list(rt.code) == [0]
    _same(j, t, late + 3, "maintained")


def test_queue_dump_metrics_and_trace_overlay():
    from antrea_tpu_torch.observability.metrics import render_metrics

    ps, svcs = _world()
    j, t = _pair(ps, svcs)
    p = _fresh_pkt(CLIENT, SRV)
    _step_both(j, t, [p], next(_NOW))
    [row] = t.dump_miss_queue()
    assert row["src"] == CLIENT and row["dst"] == SRV
    text = render_metrics(t, node="n1")
    assert 'antrea_tpu_miss_queue_depth{node="n1"} 1' in text
    b = PacketBatch.from_packets([p])
    assert j.trace(b, next(_NOW)) == t.trace(tb(b), next(_NOW))
    _drain_both(j, t, next(_NOW))
    assert t.dump_miss_queue() == []
    assert "antrea_tpu_slowpath_drain_batch_size_bucket" in render_metrics(
        t, node="n1")
    assert t.trace(tb(b), next(_NOW))[0]["queued"] is False


@pytest.mark.parametrize("mode", MODES)
def test_overlap_commit_visible_to_next_batch_lost_update_guard(mode):
    """overlap_commits: the drain's read-back is deferred in the two-slot
    ring, yet the next step already sees its commits (the state was
    updated in stream order); the flush settles the metrics."""
    ps, svcs = _world()
    j, t = _pair(ps, svcs, mode, overlap_commits=True)
    probes = [_fresh_pkt(BLOCKED, SRV), _fresh_pkt(CLIENT, SRV),
              _fresh_pkt(CLIENT2, "10.96.0.1")]
    _step_both(j, t, probes, next(_NOW))
    _drain_both(j, t, next(_NOW))
    s = t.slowpath_stats()
    assert (s["overlap"], s["overlap_depth"],
            s["deferred_commits_total"]) == (1, 1, 1)
    assert t.stats().ingress == {}  # the drain's metrics are deferred
    rt = _step_both(j, t, probes, next(_NOW))
    assert list(rt.pending) == [0, 0, 0] and list(rt.code) == [1, 0, 0]
    assert rt.dnat_port[2] == 8080
    assert t.flush_slowpath() == j.flush_slowpath() == 1
    _same(j, t, next(_NOW), mode)


def test_overlap_reenqueue_of_pending_flow_is_idempotent():
    ps, svcs = _world()
    j, t = _pair(ps, svcs, overlap_commits=True)
    p = _fresh_pkt(CLIENT, "10.96.0.1")
    _step_both(j, t, [p], next(_NOW))
    _step_both(j, t, [p], next(_NOW))
    assert t.slowpath_stats()["depth"] == 2
    _drain_both(j, t, next(_NOW))
    rt = _step_both(j, t, [p], next(_NOW))
    assert list(rt.pending) == [0] and list(rt.code) == [0]
    t.flush_slowpath(), j.flush_slowpath()
    _same(j, t, next(_NOW), "re-enqueue")


@pytest.mark.parametrize("mode", MODES)
def test_overlap_epoch_swap_mid_drain_reclassifies(mode):
    """A bundle mid-overlap (a commit staged from an earlier drain, a drain
    in flight): the in-flight batch reclassifies under the new tensors and
    the staged commit keeps its dispatch-time attribution.  Then, with a
    commit staged, a bundle that renumbers the rules: once rolled back by
    a failing canary (the retained snapshot's flow meta is the pre-remap
    one) and once committed (the drained entries' attribution remapped)."""
    ps, svcs = _world()
    ps2, _ = _world(blocked_ip=CLIENT)
    ps3, _ = _world(blocked_ip=CLIENT, extra=2)
    j, t = _pair(ps, svcs, mode, overlap_commits=True, canary_probes=4)
    warm, probe = _fresh_pkt(CLIENT2, SRV), _fresh_pkt(CLIENT, SRV)
    _step_both(j, t, [warm], next(_NOW))
    _drain_both(j, t, next(_NOW))
    _step_both(j, t, [probe], next(_NOW))
    now = next(_NOW)
    for dp, ps_ in ((j, copy.deepcopy(ps2)), (t, port_ps(ps2))):
        assert dp._slowpath.overlap_depth == 1
        assert dp._slowpath.begin_drain(now)
        dp.install_bundle(ps=ps_)
        assert dp._slowpath.finish_drain(now + 1)["stale_reclassified"] == 1
    assert list(_step_both(j, t, [probe], next(_NOW)).code) == [1]
    assert t.flush_slowpath() == j.flush_slowpath() == 2
    _same(j, t, next(_NOW), f"{mode} swapped")

    denied = _fresh_pkt(CLIENT, SRV)
    _step_both(j, t, [denied], next(_NOW))
    _drain_both(j, t, next(_NOW))  # staged again
    meta0 = t._state.flow.meta
    for dp, plan, ps_ in ((j, JFaultPlan(), copy.deepcopy(ps3)),
                          (t, TFaultPlan(), port_ps(ps3))):
        dp.arm_commit_faults(plan, "n1")
        plan.after("n1.canary", plan.hits("n1.canary"), "fail", times=1)
        with pytest.raises(Exception, match="canary"):
            dp.install_bundle(ps=ps_)
    assert t._state.flow.meta is meta0  # the snapshot's pre-remap rows
    _same(j, t, next(_NOW), f"{mode} rolled back")
    assert (j.install_bundle(ps=copy.deepcopy(ps3))
            == t.install_bundle(ps=port_ps(ps3)))
    assert t._state.flow.meta is not meta0
    # The cached denial is of the old generation: it misses again.
    assert list(_step_both(j, t, [denied], next(_NOW)).pending) == [1]
    assert t.flush_slowpath() == j.flush_slowpath() == 1
    _same(j, t, next(_NOW), f"{mode} remapped")


def test_drain_reclaim_splits_dead_rows_from_evictions():
    """flow_slots=1: a drain insert over an idle-expired or a
    stale-generation row is a reclaim, over a live one an eviction."""
    ps, svcs = _world()
    ps2, _ = _world(blocked_ip=CLIENT)
    j, t = _pair(ps, svcs, flow_slots=1, ct_timeout_s=5, drain_batch=4)
    now0 = next(_NOW)
    for now in (now0, now0 + 300, now0 + 302):
        _step_both(j, t, [_fresh_pkt(BLOCKED, SRV)], now)
        _drain_both(j, t, now + 1)
    assert (t.cache_stats()["reclaims"], t.cache_stats()["evictions"]) == (
        1, 1)
    j.install_bundle(ps=copy.deepcopy(ps2))
    t.install_bundle(ps=port_ps(ps2))
    _step_both(j, t, [_fresh_pkt(CLIENT, SRV)], now0 + 304)
    for dp in (j, t):
        assert dp._slowpath.begin_drain(now0 + 305)
        dp._slowpath.finish_drain(now0 + 305)
    assert (t.cache_stats()["reclaims"], t.cache_stats()["evictions"]) == (
        2, 1)
    _same(j, t, now0 + 305, "reclaim")


def test_autotuner_hysteresis_equals_reference():
    """The port's DrainAutotuner walks the rung ladder as the JAX
    package's does on the same pressure signals (step up, step down, a
    dead band, jitter, overflow pressure, clamped bounds)."""
    from antrea_tpu.datapath.slowpath import DrainAutotuner as J
    from antrea_tpu_torch.datapath.slowpath import DrainAutotuner as T

    sigs = ([(10**6, 0)] * 12 + [(0, 0)] * 20 + [(4096, 0)] * 5
            + [(10**6 if i % 2 else 0, 0) for i in range(12)]
            + [(0, 5)] * 3)
    for args in ((4096, 256, 65536), (256, 256, 65536), (4096, 1024, 16384)):
        a, b = J(*args), T(*args)
        assert ([a.observe(*s) for s in sigs]
                == [b.observe(*s) for s in sigs]), args
        assert (a.decisions_up, a.decisions_down) == (b.decisions_up,
                                                      b.decisions_down)
    b = T(4096, 256, 65536)
    up = [b.observe(10**6, 0) for _ in range(12)]
    assert up[-1] == 65536 and all(y >= x for x, y in zip(up, up[1:]))


def test_autotuned_engine_steps_chunk_against_queue_pressure():
    """The engine's chunk follows queue pressure on the rung ladder with
    the JAX engine's decisions, and the retuned chunk drains: the drain
    meta changes, nothing compiles."""
    ps, svcs = _world()
    j, t = _pair(ps, svcs, flow_slots=1 << 14, queue=2048,
                 autotune_drain=True, autotune_bounds=(256, 4096))
    assert t._slowpath.drain_batch == 256
    storm = [_fresh_pkt(CLIENT, SRV) for _ in range(600)]
    b = PacketBatch.from_packets(storm)
    for _ in range(2):
        now = next(_NOW)
        _step_both(j, t, None, now, batch=b)
        for dp in (j, t):
            dp.drain_slowpath(now, max_batches=0)
    s = t.slowpath_stats()
    assert s["drain_batch"] == 1024 and s["autotune_decisions_up"] == 1
    assert t._drain_meta(1024).miss_chunk == 1024
    assert _drain_both(j, t, next(_NOW))["drained"] == 1200
    rt = _step_both(j, t, [storm[0]], next(_NOW))
    assert list(rt.pending) == [0] and list(rt.code) == [0]
    _same(j, t, next(_NOW), "autotune")


def test_hold_admission_leaves_punt_and_arp_lanes_alone():
    ps, svcs = _world()
    j, t = _pair(ps, svcs, admission="hold")
    igmp = Packet(src_ip=iputil.ip_to_u32(CLIENT),
                  dst_ip=iputil.ip_to_u32("224.0.0.22"), proto=2,
                  src_port=0, dst_port=0)
    arp = Packet(src_ip=iputil.ip_to_u32(CLIENT),
                 dst_ip=iputil.ip_to_u32(SRV), proto=0, src_port=0,
                 dst_port=0)
    b = PacketBatch.from_packets([igmp, arp, _fresh_pkt(CLIENT, SRV)])
    b.arp_op = np.array([0, 1, 0], np.int32)
    rt = _step_both(j, t, None, next(_NOW), batch=b)
    assert list(rt.code) == [0, 0, 1] and list(rt.pending) == [0, 0, 1]
    assert t.slowpath_stats()["depth"] == 1


def test_async_knobs_need_async_mode_and_the_card(monkeypatch):
    """overlap_commits / autotune_drain / the source buckets configure the
    async engine (ConfigError without it, as in the JAX package), and the
    async engine, like every entry point, runs on the card unless asked
    for the CPU."""
    ps, svcs = _world()
    for kw in ({"overlap_commits": True}, {"autotune_drain": True},
               {"miss_source_rate": 4.0}):
        with pytest.raises(ConfigError, match="async_slowpath"):
            td.TpuflowDatapath(port_ps(ps), port_svcs(svcs), device="cpu",
                               **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.TpuflowDatapath(port_ps(ps), port_svcs(svcs), async_slowpath=True)
