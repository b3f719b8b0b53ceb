"""Canonical-shape serving batcher (the serving half of the batching plane).

The production gap this closes: `step_tenants` used to partition mixed
batches into per-(rung, traffic-shape) dispatches, so the XLA executable
count tracked whatever batch sizes tenants happened to send — unbounded
— and a one-lane trickle either burned a fresh compile or had no latency
story at all.  The batcher is a pure re-shaping layer in front of the
jitted step:

  * **Admission** — `submit()` appends lanes to a bounded per-world
    staging ring (O(lanes), no dispatch on the submitter's critical
    path).  A full ring sheds the tail, metered, never unbounded memory.
  * **Canonical ladder** — flushes pack staged lanes onto a small
    declared ladder of pow2 batch sizes; a partial chunk pads up to the
    smallest rung that fits and the padding lanes are masked through the
    engines' `valid` discipline (HLO-invisible: padded lanes behave
    exactly like spoof-dropped lanes — no state commit, no miss
    admission, no policy counters).  Compile count is therefore bounded
    by `occupied rungs x len(canonical_sizes)`, never by traffic.
  * **Flush policy** — depth-OR-deadline on the maintenance scheduler's
    tick clock (`FaultClock`-deterministic in tests): a ring flushes
    when it holds `flush_depth` lanes or its oldest lane has aged
    `flush_deadline` ticks.  The deadline knob is the per-tenant p99
    lever, observable on the telemetry plane's `batched` scope.
  * **Fairness** — deficit-round-robin over the staging rings with
    starvation aging (the maintenance-scheduler pattern): due rings bank
    a deficit credit per deferred tick, a ring deferred
    `STARVATION_TICKS` consecutive ticks jumps the queue, and depth-due
    rings always outrank deadline-due ones so a deadline storm cannot
    grow memory (depth-flush dominates).
  * **De-interleave** — results return lane-exactly to submitters
    (verdict fields scattered back per ticket, `n_miss` and the Service
    LB's counters `lb` summed once per dispatch), so oracle parity holds
    regardless of how lanes were coalesced.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..config import ConfigError
from ..observability.flightrec import emit_into
from ..observability.metrics import Histogram
from ..observability.telemetry import classify_regime

# Default pow2 ladder; engines override via the `canonical_sizes` knob.
CANONICAL_SIZES = (16, 64, 256, 1024)

# Consecutive deferred-while-due ticks before a ring jumps the DRR queue
# (mirrors MaintenanceScheduler.STARVATION_TICKS).
STARVATION_TICKS = 8

# Deficit credits are capped so an idle-then-bursty world cannot bank an
# unbounded scheduling advantage.
DEFICIT_CAP = 64

# Tick-unit bounds for the per-world wait histogram (a lane's staging age
# at flush, in maintenance ticks — the p99 the deadline knob moves).
WAIT_TICK_BOUNDS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class _Ring:
    """Bounded staging ring for one world (default world = tenant 0)."""

    __slots__ = ("tid", "segs", "depth", "opened", "starved", "deficit")

    def __init__(self, tid: int) -> None:
        self.tid = tid
        self.segs: list = []  # (tickets ndarray, PacketBatch, submit tick)
        self.depth = 0
        self.opened = 0  # tick the oldest staged lane arrived
        self.starved = 0  # consecutive due-but-deferred ticks
        self.deficit = 0  # banked DRR credits


def _concat_batches(batches):
    """Lane-concatenate PacketBatches (optional columns preserved; a
    column is kept only when present on every segment — submissions to
    one ring share a schema in practice)."""
    if len(batches) == 1:
        return batches[0]
    kw = {}
    for f in dataclasses.fields(batches[0]):
        cols = [getattr(b, f.name) for b in batches]
        if any(c is None for c in cols):
            kw[f.name] = None
        else:
            kw[f.name] = np.concatenate([np.asarray(c) for c in cols])
    return type(batches[0])(**kw)


def _pad_batch(batch, lo: int, n: int, size: int):
    """Slice lanes [lo, lo+n) and pad up to `size` by repeating the last
    real lane (edge padding keeps every column in-domain — the pad lanes
    are masked out via `valid`, so their contents only need to trace)."""
    kw = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is None:
            kw[f.name] = None
            continue
        v = np.asarray(v)[lo : lo + n]
        if n < size:
            pad = [(0, size - n)] + [(0, 0)] * (v.ndim - 1)
            v = np.pad(v, pad, mode="edge")
        kw[f.name] = v
    return type(batch)(**kw)


class ServingBatcher:
    """Batching admission plane in front of one datapath (see module
    docstring for the policy)."""

    def __init__(
        self,
        dp,
        *,
        canonical_sizes=None,
        flush_depth: Optional[int] = None,
        flush_deadline: int = 4,
        ring_slots: Optional[int] = None,
        results_slots: Optional[int] = None,
    ) -> None:
        sizes = tuple(
            int(s) for s in (CANONICAL_SIZES if canonical_sizes is None else canonical_sizes)
        )
        if not sizes:
            raise ConfigError("canonical_sizes must declare at least one batch size")
        for s in sizes:
            if s <= 0 or (s & (s - 1)) != 0:
                raise ConfigError(
                    f"canonical batch size {s} is not a positive power of two — "
                    "the compile-count bound holds only over a declared pow2 ladder"
                )
        if list(sizes) != sorted(set(sizes)):
            raise ConfigError("canonical_sizes must be strictly ascending")
        self.sizes = sizes
        self.flush_depth = int(flush_depth) if flush_depth is not None else sizes[-1]
        if self.flush_depth <= 0:
            raise ConfigError("flush_depth must be positive")
        self.flush_deadline = int(flush_deadline)
        if self.flush_deadline < 1:
            raise ConfigError("flush_deadline must be >= 1 maintenance tick")
        self.ring_slots = int(ring_slots) if ring_slots is not None else 4 * self.flush_depth
        if self.ring_slots < self.flush_depth:
            raise ConfigError(
                f"ring_slots ({self.ring_slots}) must hold at least one flush_depth "
                f"({self.flush_depth}) of staged lanes"
            )
        self.results_slots = (
            int(results_slots) if results_slots is not None else 4 * self.ring_slots
        )

        self._dp = dp
        self._rings: dict = {}
        self._completed: dict = {}  # ticket -> (StepResult, row) — insertion-ordered
        self._next_ticket = 0
        self._rr_cursor = 0

        # Meters (serving_stats; scraped as the serving metric families
        # registered in observability/metrics.py).
        self.submitted_total = 0
        self.shed_total = 0
        self.flushed_lanes_total = 0
        self.padded_total = 0
        self.dispatches_total = 0
        self.flushes_total = {"depth": 0, "deadline": 0, "forced": 0, "overflow": 0}
        self.deadline_exceeded_total = 0
        self.results_dropped_total = 0
        self._wait_hists: dict = {}  # tid -> Histogram (tick units)

    # -- clock / plumbing ----------------------------------------------------

    def _tick(self) -> int:
        sched = getattr(self._dp, "_maintenance", None)
        return 0 if sched is None else int(sched.clock())

    def _emit(self, kind: str, **fields) -> None:
        emit_into(self._dp, kind, **fields)

    def _ring(self, tid: int) -> _Ring:
        r = self._rings.get(tid)
        if r is None:
            r = self._rings[tid] = _Ring(tid)
        return r

    def _wait_hist(self, tid: int) -> Histogram:
        h = self._wait_hists.get(tid)
        if h is None:
            h = self._wait_hists[tid] = Histogram(bounds=WAIT_TICK_BOUNDS)
        return h

    # -- admission -----------------------------------------------------------

    def submit(self, batch, now: float, *, tenant: int = 0, shed: bool = True) -> np.ndarray:
        """Stage `batch`'s lanes into `tenant`'s ring; returns one ticket
        per lane (-1 = shed).  With shed=False a full ring force-flushes
        inline instead of shedding (the lossless synchronous path
        `step_tenants` uses); with shed=True lanes beyond the ring's
        capacity tail-drop, metered — the bounded-memory contract."""
        tid = int(tenant)
        if tid != 0:
            self._tenants.world(tid)  # raises KeyError on unknown tenants
        # Fold traffic time into the tick clock exactly like step() does:
        # staging ages and the deadline policy must live in the same clock
        # domain as the dispatches that will eventually observe this now.
        sched = getattr(self._dp, "_maintenance", None)
        if sched is not None:
            sched.observe(now)
        ring = self._ring(tid)
        n = batch.size
        tickets = np.full(n, -1, np.int64)
        lo = 0
        while lo < n:
            room = self.ring_slots - ring.depth
            if room <= 0:
                if not shed:
                    self._flush_ring(ring, now, "overflow")
                    continue
                self.shed_total += n - lo
                break
            take = min(room, n - lo)
            tk = np.arange(self._next_ticket, self._next_ticket + take, dtype=np.int64)
            self._next_ticket += take
            tickets[lo : lo + take] = tk
            t = self._tick()
            if ring.depth == 0:
                ring.opened = t
            seg = batch if (lo == 0 and take == n) else _sub(batch, lo, take)
            ring.segs.append((tk, seg, t))
            ring.depth += take
            self.submitted_total += take
            lo += take
        return tickets

    @property
    def _tenants(self):
        reg = getattr(self._dp, "_tenants", None)

        class _Default:
            @staticmethod
            def world(tid):
                raise KeyError(f"unknown tenant id {tid}")

        return reg if reg is not None else _Default

    # -- flush plane ---------------------------------------------------------

    def tick_flush(self, now: float, budget: int) -> int:
        """Maintenance-task body (`serving-flush`): flush due rings in
        DRR order, depth-due before deadline-due, starved rings boosted;
        returns dispatches spent (the scheduler's budget unit)."""
        t = self._tick()
        due = []
        for tid, ring in self._rings.items():
            if ring.depth <= 0:
                continue
            depth_due = ring.depth >= self.flush_depth
            deadline_due = (t - ring.opened) >= self.flush_deadline
            if depth_due or deadline_due:
                ring.deficit = min(ring.deficit + 1, DEFICIT_CAP)
                due.append((tid, ring, depth_due))
        if not due:
            return 0
        n_worlds = max(1, len(self._rings))
        due.sort(
            key=lambda e: (
                0 if e[2] else 1,  # depth-due dominates (memory bound)
                0 if e[1].starved >= STARVATION_TICKS else 1,
                -e[1].deficit,
                (e[0] - self._rr_cursor) % (2 * n_worlds + 1),
            )
        )
        spent = 0
        cap = max(1, int(budget))
        for tid, ring, depth_due in due:
            if spent >= cap:
                ring.starved += 1
                continue
            spent += self._flush_ring(ring, now, "depth" if depth_due else "deadline")
            ring.starved = 0
            ring.deficit = 0
            self._rr_cursor = tid + 1
        return spent

    def flush_all(self, now: float) -> int:
        """Force-flush every non-empty ring (the synchronous
        `step_tenants` path); returns dispatches spent."""
        spent = 0
        for ring in self._rings.values():
            if ring.depth > 0:
                spent += self._flush_ring(ring, now, "forced")
        return spent

    def _flush_ring(self, ring: _Ring, now: float, reason: str) -> int:
        t = self._tick()
        age = t - ring.opened
        segs, ring.segs, ring.depth = ring.segs, [], 0
        tickets = np.concatenate([s[0] for s in segs])
        waits = np.concatenate(
            [np.full(s[0].size, t - s[2], np.int64) for s in segs]
        )
        batch = _concat_batches([s[1] for s in segs])
        tid = ring.tid
        n = int(tickets.size)

        dispatches = 0
        padded = 0
        lo = 0
        while lo < n:
            left = n - lo
            if left >= self.sizes[-1]:
                take, size = self.sizes[-1], self.sizes[-1]
            else:
                size = next(s for s in self.sizes if s >= left)
                take = left
            pb = _pad_batch(batch, lo, take, size)
            vmask = np.zeros(size, bool)
            vmask[:take] = True
            t0 = time.perf_counter()
            if tid == 0:
                res = self._dp.step(pb, now, valid=vmask)
            else:
                res = self._dp.tenant_step(tid, pb, now, valid=vmask)
            dt = time.perf_counter() - t0
            tp = getattr(self._dp, "_telemetry", None)
            if tp is not None:
                regime = classify_regime(take, int(res.n_miss))
                tp.observe_scoped("batched", regime, dt)
                if tid:
                    tp.observe_scoped(f"batched:tenant:{tid}", regime, dt)
            for i in range(take):
                self._complete(int(tickets[lo + i]), res, i)
            dispatches += 1
            padded += size - take
            lo += take

        hist = self._wait_hist(tid)
        for w in waits:
            hist.observe(float(w))
        self.flushed_lanes_total += n
        self.padded_total += padded
        self.dispatches_total += dispatches
        self.flushes_total[reason] = self.flushes_total.get(reason, 0) + 1
        self._emit(
            "batch-flush",
            tenant=tid,
            lanes=n,
            padded=padded,
            dispatches=dispatches,
            reason=reason,
            age_ticks=int(age),
        )
        if age > self.flush_deadline:
            self.deadline_exceeded_total += 1
            self._emit(
                "batch-deadline-exceeded",
                tenant=tid,
                age_ticks=int(age),
                deadline=self.flush_deadline,
            )
        return dispatches

    # -- result plane --------------------------------------------------------

    def _complete(self, ticket: int, res, row: int) -> None:
        self._completed[ticket] = (res, row)
        while len(self._completed) > self.results_slots:
            oldest = next(iter(self._completed))
            del self._completed[oldest]
            self.results_dropped_total += 1

    def poll(self, ticket: int):
        """Pop one lane's completed verdict as a field dict, or None if
        still staged (or shed / aged out of the bounded result store)."""
        pair = self._completed.pop(int(ticket), None)
        if pair is None:
            return None
        res, row = pair
        out = {}
        for f in dataclasses.fields(res):
            v = getattr(res, f.name)
            if f.name == "n_miss":
                out[f.name] = int(v)
            elif f.name == "lb":
                # The dispatch's, as its n_miss; absent where it counted
                # none.
                if v is not None:
                    out[f.name] = dict(v)
            elif v is None:
                out[f.name] = None
            elif isinstance(v, list):
                out[f.name] = v[row]
            else:
                out[f.name] = np.asarray(v)[row]
        return out

    def collect(self, tickets) -> "object":
        """De-interleave completed lanes back into one StepResult in
        submission order — lane-exact: verdict columns scatter back per
        ticket, list columns move element-wise, `n_miss` sums once per
        underlying dispatch."""
        tickets = np.asarray(tickets, np.int64)
        pairs = []
        for tk in tickets:
            pair = self._completed.pop(int(tk), None)
            if pair is None:
                raise KeyError(
                    f"ticket {int(tk)} has no completed result "
                    "(still staged, shed, or aged out of the result store)"
                )
            pairs.append(pair)
        B = len(pairs)
        groups: dict = {}  # id(res) -> (res, [lane], [row])
        for lane, (res, row) in enumerate(pairs):
            g = groups.get(id(res))
            if g is None:
                g = groups[id(res)] = (res, [], [])
            g[1].append(lane)
            g[2].append(row)
        res0 = pairs[0][0]
        kw = {}
        for f in dataclasses.fields(res0):
            v0 = getattr(res0, f.name)
            if f.name == "n_miss":
                kw[f.name] = int(sum(int(g[0].n_miss) for g in groups.values()))
            elif f.name == "lb":
                lbs = [g[0].lb for g in groups.values() if g[0].lb is not None]
                kw[f.name] = ({k: sum(c[k] for c in lbs) for k in lbs[0]}
                              if lbs else None)
            elif v0 is None:
                kw[f.name] = None
            elif isinstance(v0, list):
                out = [None] * B
                for res, lanes, rows in groups.values():
                    col = getattr(res, f.name)
                    if col is None:
                        continue
                    for lane, row in zip(lanes, rows):
                        out[lane] = col[row]
                kw[f.name] = out
            else:
                a0 = np.asarray(v0)
                out = np.zeros((B,) + a0.shape[1:], a0.dtype)
                for res, lanes, rows in groups.values():
                    col = getattr(res, f.name)
                    if col is None:
                        continue
                    out[np.asarray(lanes)] = np.asarray(col)[np.asarray(rows)]
                kw[f.name] = out
        return type(res0)(**kw)

    # -- observability -------------------------------------------------------

    def staged_lanes(self) -> int:
        return sum(r.depth for r in self._rings.values())

    def wait_p99_ticks(self, tenant: int = 0) -> float:
        """p99 staging wait in ticks for one world, from the bucketed
        histogram (upper-bound estimate) — the lever `flush_deadline`
        moves."""
        h = self._wait_hists.get(int(tenant))
        if h is None or h.count == 0:
            return 0.0
        target = 0.99 * h.count
        acc = 0
        for bound, c in zip(h.bounds, h._counts):
            acc += c
            if acc >= target:
                return float(bound)
        return float(h.bounds[-1])

    def stats(self) -> dict:
        per_world = {}
        for tid, ring in sorted(self._rings.items()):
            h = self._wait_hists.get(tid)
            per_world[tid] = {
                "staged_lanes": ring.depth,
                "starved": ring.starved,
                "flushed_lanes": 0 if h is None else h.count,
                "wait_p99_ticks": self.wait_p99_ticks(tid),
            }
        return {
            "canonical_sizes": list(self.sizes),
            "flush_depth": self.flush_depth,
            "flush_deadline": self.flush_deadline,
            "ring_slots": self.ring_slots,
            "submitted_lanes": self.submitted_total,
            "shed_lanes": self.shed_total,
            "flushed_lanes": self.flushed_lanes_total,
            "padded_lanes": self.padded_total,
            "dispatches": self.dispatches_total,
            "flushes": dict(self.flushes_total),
            "deadline_exceeded": self.deadline_exceeded_total,
            "results_dropped": self.results_dropped_total,
            "staged_lanes": self.staged_lanes(),
            "worlds": per_world,
        }

    def hist_rows(self, node: str) -> list:
        """(family, labels, Histogram) rows for the metrics renderer."""
        return [
            (
                "antrea_tpu_serving_wait_ticks",
                {"tenant": str(tid), "node": node},
                h,
            )
            for tid, h in sorted(self._wait_hists.items())
        ]


def _sub(batch, lo: int, n: int):
    kw = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        kw[f.name] = None if v is None else np.asarray(v)[lo : lo + n]
    return type(batch)(**kw)
