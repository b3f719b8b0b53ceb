"""The Service LB's counters and span, on the CPU.

Every step's StepResult.lb, and lb_stats()' totals, equal the counts
recomputed from the plain reference's replay of the same steps
(flowbench/reference/): its LB result (which lanes resolved to a Service,
with affinity, pinned, without endpoints), its flow-commit targets (which
lanes missed), its affinity writes (the pins written) and its pins before
and after each commit (the live pins of another key overwritten).  An
engine without Services counts nothing, launches what it launched before
the counters and answers as before; and the walk.lb span nests under
walk.classify."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import service_cell
import torch_cpu  # noqa: F401  (one torch thread a worker)
from antrea_tpu_torch.models import pipeline as pl
from antrea_tpu_torch.observability import tracing
from flowbench import harness
from flowbench.reference.datapath import Replay
from flowbench.stream import Stream
from flowbench.world import build_world, plain_world

SEED = 2**31 + 11
STEPS = 10


class _Replay:
    """The reference's replay, its step opened up: the LB's answer, the
    commit targets and the affinity table before and after."""

    def __init__(self, plain):
        self.ref = Replay(plain, "cpu")
        self.seen = {}
        resolve, last = self.ref.lb.resolve, self.ref._last

        def resolve_seen(*a):
            self.seen["lb"] = out = resolve(*a)
            return out

        def last_seen(slots, n):
            self.seen.setdefault("targets", []).append(slots)
            return last(slots, n)

        self.ref.lb.resolve, self.ref._last = resolve_seen, last_seen

    def counts(self, cols, now: int) -> dict:
        """One step replayed -> the LB's counters as the reference has
        them."""
        ref, A = self.ref, self.ref.aff_slots
        self.seen = {}
        before = [t.clone() for t in ref.aff]
        ref.step(ref.lanes(cols), now, outputs=False)
        lb = self.seen["lb"]
        flow, aff = self.seen["targets"]
        # The forward half of the commit targets: the misses that commit
        # (every miss to a Service: no frontend is multicast).
        miss = flow[0::2] != ref.slots
        svc = lb["svc"]
        on = (svc >= 0) & (ref.lb.aff[svc.clamp(min=0)] > 0)
        pinned = on & ~lb["no_ep"] & ~lb["learn"]
        slots = torch.unique(aff[aff != A])
        c_b, s_b, e_b, ts_b = (t[slots] for t in before)
        c_a, s_a = ref.aff[0][slots], ref.aff[1][slots]
        live = (e_b > 0) & (now - ts_b <= ref.lb.aff[s_b])
        other = (c_b != c_a) | (s_b != s_a)
        return {"lb": int((miss & (svc >= 0)).sum()),
                "lb_aff": int((miss & on).sum()),
                "aff_hit": int((miss & pinned).sum()),
                "no_ep": int((miss & lb["no_ep"]).sum()),
                "aff_learn": int(slots.numel()),
                "aff_overwrite": int((live & other).sum())}


def _world(aff_slots, **engine):
    cfg = service_cell.config("one_ns_10k_svc10k", aff_slots=aff_slots,
                              **engine)
    # More Services without endpoints and with affinity than the cell's
    # cut has, so that every counter moves.
    cfg["services"].update(no_endpoints=4, affinity_share=0.5)
    return build_world(cfg)


@pytest.mark.parametrize("aff_slots,engine", [
    (1 << 5, {}),
    (1 << 12, {}),
    (1 << 5, {"fused": False, "prune_budget": 0, "miss_chunk": 512}),
], ids=["onepass-32-slots", "onepass-4096-slots", "staged-32-slots"])
def test_counters_equal_the_reference(aff_slots, engine):
    w = _world(aff_slots, **engine)
    plain = plain_world(w)
    stream = Stream(service_cell.mix("svc_churn"), plain, SEED)
    eng = harness.build_engine(w, "cpu")
    ref = _Replay(plain)
    total = dict.fromkeys(pl.LB_STATS, 0)
    for t in range(STEPS):
        r = eng.step(stream.batch(t), stream.now(t))
        stream.observe(t, r)
        want = ref.counts(stream.columns(t), stream.now(t))
        assert r.lb == want, t
        assert r.lb["lb"] <= r.n_miss
        for k, v in want.items():
            total[k] += v
    assert eng.lb_stats() == total
    assert all(total[k] > 0 for k in ("lb", "lb_aff", "aff_hit", "no_ep",
                                      "aff_learn"))
    if aff_slots == 1 << 5:
        assert 0 < total["aff_overwrite"] <= total["aff_learn"]


class _Ops(TorchDispatchMode):
    """Counts the aten operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _digest(r, h) -> None:
    for f in dataclasses.fields(r):
        v = getattr(r, f.name)
        if isinstance(v, np.ndarray):
            h.update(f.name.encode())
            h.update(np.asarray(v, np.int64).tobytes())
        elif v is not None:
            h.update(f.name.encode())
            h.update(repr(v).encode())


# Aten operations of each step and the digest of every StepResult field
# of the 12 steps below, counted on the CPU before the LB had counters.
OPS_BEFORE = [1226] + [1306] * 11
DIGEST_BEFORE = ("7956a0044aedd00e5775a48c1d89130494561fa6"
                 "ec2530e690784ae40cd30c0b")


def test_an_engine_without_services_counts_nothing_as_before():
    """conn_churn's classes on one_ns_10k's world, cut: no LB counters,
    the same operations a step, and the same results."""
    w = build_world(service_cell.config("one_ns_10k"))
    stream = Stream(service_cell.mix("conn_churn"), plain_world(w), SEED)
    eng = harness.build_engine(w, "cpu")
    h, ops = hashlib.sha256(), []
    for t in range(12):
        mode = _Ops()
        with mode:
            r = eng.step(stream.batch(t), stream.now(t))
        ops.append(mode.n)
        assert r.lb is None and r.n_miss > 0
        _digest(r, h)
    assert eng.lb_stats() is None
    assert ops == OPS_BEFORE
    assert h.hexdigest() == DIGEST_BEFORE


@pytest.mark.parametrize("engine", [{}, {"fused": False, "prune_budget": 0,
                                         "miss_chunk": 64}],
                         ids=["onepass", "staged-rounds"])
def test_walk_lb_nests_under_walk_classify(engine):
    w = _world(1 << 5, **engine)
    stream = Stream(service_cell.mix("svc_churn"), plain_world(w), SEED)
    eng = harness.build_engine(w, "cpu")
    rec = eng.enable_step_spans(4096)
    for t in range(4):
        r = eng.step(stream.batch(t), stream.now(t))
        stream.observe(t, r)
    assert tracing.SLOT.sp is None
    spans = {}
    for seq, name, parent, t0, t1 in rec.records():
        spans.setdefault(seq, []).append((name, parent, t0, t1))
    assert sorted(spans) == [1, 2, 3, 4]
    for step in spans.values():
        lbs = [s for s in step if s[0] == "walk.lb"]
        cls = [s for s in step if s[0] == "walk.classify"]
        assert lbs and len(lbs) == len(cls)
        for (_, parent, t0, t1), (_, _, c0, c1) in zip(lbs, cls):
            assert parent == "walk.classify" and c0 <= t0 <= t1 <= c1
    st = rec.stats()["spans"]
    assert st["walk.lb"]["total_s"] <= st["walk.classify"]["total_s"]
    if engine:
        assert st["walk.lb"]["count"] > 4


def test_learn_census_counts_live_pins_of_other_keys():
    """_commit's census on a hand-set learn table: each slot's winning
    learn once; an overwrite only where the row is live (younger than its
    own Service's timeout) and holds another (client, Service) key."""
    A, now = 8, 100
    state = pl.init_state(16, A, device="cpu")
    aff = state.aff
    # Slot 1: a live pin of (10, svc 0); slot 2: (11, svc 1), expired;
    # slot 3: a live pin of (12, svc 0).
    for slot, (c, s, e, ts) in {1: (10, 0, 1, 95), 2: (11, 1, 2, 10),
                                3: (12, 0, 1, 90)}.items():
        aff.key_client[slot], aff.key_svc[slot] = c, s
        aff.ep[slot], aff.ts[slot] = e, ts
    i32 = torch.int32
    learn = {"aslot": torch.tensor([1, 2, 3, 3, 4]),
             "client": torch.tensor([10, 13, 14, 15, 16], dtype=i32),
             "svc": torch.tensor([0, 1, 0, 0, 1], dtype=i32),
             "ep": torch.tensor([2, 1, 1, 2, 1], dtype=i32)}
    mask = torch.tensor([True, True, True, True, False])
    m = 5
    rows = {"rev_slot": torch.zeros(m, dtype=i32),
            "keys8": torch.zeros(m, 8, dtype=i32),
            "meta8": torch.zeros(m, 8, dtype=i32),
            "ins": torch.zeros(m, dtype=torch.bool),
            "rev_ins": torch.zeros(m, dtype=torch.bool)}
    meta = pl.PipelineMeta(match=None, flow_slots=16, aff_slots=A,
                           ct_timeout_s=3600, miss_chunk=m)
    *_, census = pl._commit(state, torch.zeros(m, dtype=torch.int64), rows,
                            learn, mask, now, 0, meta,
                            aff_timeout=torch.tensor([50, 50], dtype=i32))
    # Slots 1 (the same key), 2 (expired) and 3 (live, another key; lane
    # 3 wins it) are written; only slot 3's learn overwrote a live pin.
    assert census.tolist() == [3, 1]
    assert aff.key_client[3] == 15 and aff.ep[1] == 2
    *_, none = pl._commit(state, torch.zeros(m, dtype=torch.int64), rows,
                          learn, mask, now, 0, meta)
    assert none is None


def test_the_batcher_sums_each_dispatchs_counters():
    """step_tenants over the serving batcher: one StepResult of several
    dispatches carries their counters summed, as lb_stats() counted
    them; a lane's poll carries its dispatch's."""
    from antrea_tpu_torch.datapath import TpuflowDatapath

    w = _world(1 << 5)
    stream = Stream(service_cell.mix("svc_churn"), plain_world(w), SEED)
    eng = TpuflowDatapath(w.ps, w.services, device="cpu", topology=w.topology,
                          serving_batcher=True, canonical_sizes=(128,),
                          **w.config["engine"])
    before = eng.lb_stats()
    b = stream.batch(0)
    r = eng.step_tenants(np.zeros(b.size, np.int64), b, stream.now(0))
    after = eng.lb_stats()
    assert r.lb == {k: after[k] - before[k] for k in pl.LB_STATS}
    assert r.lb["lb"] > 0 and eng.serving_stats()["dispatches"] == 4
    stream.observe(0, r)
    bt = eng.serving_batcher()
    tk = bt.submit(stream.batch(1), stream.now(1))
    bt.flush_all(stream.now(1))
    got = bt.poll(int(tk[0]))
    assert set(got["lb"]) == set(pl.LB_STATS)
