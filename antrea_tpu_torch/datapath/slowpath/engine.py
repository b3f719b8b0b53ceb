"""Background classification engine + epoch-swapped publication.

One engine instance serves one datapath (either twin — the owner is
duck-typed).  The contract with the owner:

  owner.generation           current bundle generation (epoch staleness)
  owner._drain_classify(block, now)
                             run the full slow path over one popped queue
                             block (ServiceLB -> classify -> commit via
                             the coalesced drain step), publish the new
                             cache state, and account rule metrics
  owner._epoch_revalidate()  reclaim stale-generation denial entries off
                             the hot step -> count (lazy revalidation;
                             established entries untouched)
  owner._epoch_age_scan(now) reclaim idle-expired entries -> count

Admission policies (the provisional verdict a queued miss carries until
the engine classifies its flow):

  ADMIT_FORWARD  default-forward (ACT_ALLOW, no DNAT): the packet
                 proceeds un-rewritten while its flow awaits
                 classification — the OVS "handle the first packet in
                 userspace, let it through per the default" shape.
  ADMIT_HOLD     drop until classified (ACT_DROP): strict admission for
                 deny-by-default postures; the flow passes only after a
                 drain has committed its verdict.
  ADMIT_DROP     forward-with-early-drop (round 10, ROADMAP item 4's
                 admission half): packets keep ADMIT_FORWARD's
                 provisional ACT_ALLOW, but once a queue is past
                 EARLY_DROP_FLOOR of its capacity, miss ADMISSIONS are
                 probabilistically shed — depth-proportional, ramping
                 to 1.0 at a full ring — so an attack load (the
                 gen_syn_flood shape: never-repeating tuples, 100%
                 admissions) degrades smoothly BEFORE the tail-drop
                 cliff instead of saturating the drain pipeline.  The
                 shed decision is a DETERMINISTIC per-flow 5-tuple hash
                 coin (salted per process — see _EARLY_DROP_SALT — so
                 the shed set is not attacker-predictable), not an RNG,
                 so the oracle twin sheds identical lanes and verdict
                 parity stays provable under attack;
                 a shed flow simply re-tries admission on its next
                 miss.  Metered as `early_drops_total`
                 (antrea_tpu_miss_queue_early_drops_total).

Epoch discipline: every published slow-plane mutation (drain commit,
revalidation, aging scan) bumps `epoch`; `install_bundle` marks the
current epoch STALE (`mark_stale`).  A stale epoch is healed lazily —
the next drain first runs the owner's FUSED maintenance pass
(`_epoch_maintain`: aging + stale-generation revalidation in ONE pass
over the cache, round 6 — previously two separate full-table scans),
and an in-flight drain whose bundle generation changed between
`begin_drain` and `finish_drain` is re-classified under the NEW tensors
(counted in `stale_reclassified_total`) instead of publishing stale
verdicts.

Round-6 additions (the overlapped churn datapath, ROADMAP item 2):

  OVERLAPPED COMMITS (`overlap_commits=True`): `_drain_classify` may
  return a deferred FINALIZER (the host-side materialization + metrics
  accounting of an already-dispatched drain) instead of blocking on the
  device.  The engine stages finalizers in a two-slot pending-commit
  ring: dispatching a third drain retires the oldest (by then its device
  work has completed under the newer dispatches — the double-buffer),
  so classify of batch N+1 is dispatched BEFORE blocking on the commit
  of batch N.  The lost-update guard is structural: the owner publishes
  its new state pytree at DISPATCH time, so batch N's committed entries
  are a data dependency of batch N+1's lookups; a flow admitted before
  its commit landed simply re-enqueues and re-classifies (idempotent —
  deterministic endpoint hash, same entry).  Only OBSERVATION lags:
  rule metrics / eviction counters land at retire time, bounded by the
  two-slot depth and surfaced as `deferred_commit_staleness_s`.

  QUEUE-DEPTH AUTOTUNING (`autotune=True`): `drain_batch` is no longer a
  fixed 4096 but a rung on a small pre-compiled chunk ladder, moved at
  most one rung per decision by a hysteresis controller fed from the
  queue metrics the engine already exports — depth >= 2 rungs of backlog
  or an overflow since the last decision presses UP (drain faster than
  arrival), depth under a quarter rung presses DOWN (smaller batches,
  lower latency, cheaper padding).  A move needs AUTOTUNE_STICKY
  consecutive same-direction signals, so a step-function arrival rate
  converges without oscillating, and the ladder is closed — every rung
  is a size the owner has (or will have) a compiled drain variant for,
  so retuning can never trigger an XLA recompile storm.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Optional

import numpy as np

from ...observability.metrics import Histogram
from .queue import MissQueue

ADMIT_FORWARD = "forward"
ADMIT_HOLD = "hold"
ADMIT_DROP = "drop"

# admission="drop": the queue-depth fraction where probabilistic
# early-drop engages.  Below it every miss admits; above it the drop
# probability ramps linearly, reaching 1.0 at a full ring — RED for the
# upcall queue, tuned to spend the ring's top half absorbing bursts.
EARLY_DROP_FLOOR = 0.5

# Per-PROCESS random salt folded into the early-drop coin.  An unsalted
# 5-tuple hash would be computable offline: an attacker sustaining
# pressure could craft flows whose coin always falls below the shed
# threshold — deterministically shed at every retry, never classified,
# forwarding forever on the provisional ALLOW (a chooseable policy
# bypass).  The salt keeps the coin deterministic WITHIN a process
# (retries stay consistent; the tpuflow and oracle twins share the
# module, so differential parity holds) while making the shed set
# unpredictable across deployments — the same reasoning as the mesh's
# decorrelated shard/slot salts (parallel/mesh.py).
_EARLY_DROP_SALT = np.uint32(
    int.from_bytes(os.urandom(4), "little"))

# Per-source rate limiting (round 8, ROADMAP item 4's slow-path half —
# the reference's per-category rate-limited packet-in dispatchers,
# agent/packetin.py, applied per SOURCE instead of per category): miss
# ADMISSIONS are token-bucketed per source /24 (v4) BEFORE the
# admission="drop" depth ramp, so one scanning source exhausts its own
# bucket while everyone else's misses keep admitting at full rate even
# when the aggregate queue is calm.  Buckets refill on the packet clock
# the engine already observes (the maintenance scheduler's tick domain
# — datapath/maintenance.py drives its clock from the same `now`), so
# shedding is DETERMINISTIC: both engine twins shed the identical lanes
# and verdict parity stays provable under gen_syn_flood.  A shed flow
# keeps its provisional verdict and simply re-tries on its next miss.
SOURCE_PREFIX_SHIFT = 8  # /24 aggregation of the v4 source address
# Bucket-table bound: at the cap, buckets at full tokens (idle sources)
# are evicted first — the active attackers' buckets are precisely the
# non-full ones, so pressure can never wash out the limiter itself.
SOURCE_BUCKET_CAP = 8192

# Drain-batch sizes are packet counts, not seconds: dedicated bounds.
_DRAIN_BOUNDS = (16, 64, 256, 1024, 4096, 16384, 65536)

# The autotuner's closed chunk ladder (pre-compiled drain variants: one
# XLA program per rung ever, no recompile storms) and its hysteresis —
# consecutive same-direction pressure signals required before a move.
CHUNK_LADDER = (256, 1024, 4096, 16384, 65536)
AUTOTUNE_STICKY = 2

# Two-slot pending-commit staging: the drain double-buffer depth.  Two is
# the point of the curve — slot 1 overlaps host work with the in-flight
# device drain, slot 2 lets the NEXT drain dispatch before the first
# retires; deeper rings only grow observation staleness.
OVERLAP_SLOTS = 2


class DrainAutotuner:
    """Bounded hysteresis controller for the drain chunk size.

    Pure decision logic (no engine state) so the unit tests can drive it
    with synthetic signals: observe(depth, overflow_delta) -> the chunk
    to use for the NEXT drain.  Movement is one rung at a time, only
    after `sticky` consecutive same-direction pressure signals, and a
    move resets the streak — a step-function arrival rate walks the
    ladder monotonically and then holds (no oscillation)."""

    def __init__(self, initial: int, lo: int, hi: int,
                 sticky: int = AUTOTUNE_STICKY):
        self.lo, self.hi = int(lo), int(hi)
        self.rungs = [r for r in CHUNK_LADDER if self.lo <= r <= self.hi]
        if not self.rungs:
            raise ValueError(
                f"autotune bounds ({lo}, {hi}) exclude every ladder rung "
                f"{CHUNK_LADDER}"
            )
        # Seed at the nearest rung (ties snap down, to the cheaper chunk).
        self.idx = min(
            range(len(self.rungs)),
            key=lambda i: (abs(self.rungs[i] - int(initial)), self.rungs[i]),
        )
        self.sticky = int(sticky)
        self._streak = 0  # +k consecutive up signals, -k down
        self.decisions_up = 0
        self.decisions_down = 0

    @property
    def chunk(self) -> int:
        return self.rungs[self.idx]

    def observe(self, depth: int, overflow_delta: int) -> int:
        """Feed one decision point's queue pressure -> current chunk."""
        chunk = self.chunk
        if overflow_delta > 0 or depth >= 2 * chunk:
            signal = 1  # backlog >= two drains' worth, or drops: go up
        elif depth <= chunk // 4:
            signal = -1  # queue nearly idle at this rung: go down
        else:
            signal = 0  # in band: hold (the hysteresis dead zone)
        if signal == 0 or (self._streak and (signal > 0) != (self._streak > 0)):
            self._streak = signal  # reset on hold or direction flip
            return self.chunk
        self._streak += signal
        if self._streak >= self.sticky and self.idx < len(self.rungs) - 1:
            self.idx += 1
            self.decisions_up += 1
            self._streak = 0
        elif self._streak <= -self.sticky and self.idx > 0:
            self.idx -= 1
            self.decisions_down += 1
            self._streak = 0
        return self.chunk


class SlowPathEngine:
    def __init__(
        self,
        owner,
        *,
        capacity: int = 1 << 16,
        admission: str = ADMIT_FORWARD,
        drain_batch: int = 4096,
        autotune: bool = False,
        autotune_bounds: Optional[tuple[int, int]] = None,
        overlap_commits: bool = False,
        source_rate: Optional[float] = None,
        source_burst: Optional[int] = None,
    ):
        if admission not in (ADMIT_FORWARD, ADMIT_HOLD, ADMIT_DROP):
            raise ValueError(
                f"unknown admission policy {admission!r} "
                f"(expected {ADMIT_FORWARD!r}, {ADMIT_HOLD!r} or "
                f"{ADMIT_DROP!r})"
            )
        if drain_batch <= 0:
            raise ValueError(f"drain_batch must be positive, got {drain_batch}")
        self.owner = owner
        self.queue = MissQueue(capacity)
        self.admission = admission
        self.autotuner: Optional[DrainAutotuner] = None
        if autotune:
            lo, hi = autotune_bounds or (CHUNK_LADDER[0], CHUNK_LADDER[-1])
            self.autotuner = DrainAutotuner(int(drain_batch), lo, hi)
            self.drain_batch = self.autotuner.chunk
        else:
            self.drain_batch = int(drain_batch)
        self._overflows_seen = 0  # autotune: overflow delta baseline
        self.early_drops_total = 0  # admission="drop": shed admissions
        # Per-source-/24 admission token buckets (None = disabled):
        # prefix -> [tokens, last_refill] on the packet clock.
        self.source_rate = None if source_rate is None else float(source_rate)
        self.source_burst = (int(source_burst) if source_burst is not None
                             else (None if source_rate is None
                                   else max(1, int(2 * source_rate))))
        self._source_buckets: dict[int, list] = {}
        self.source_limited_total = 0  # admissions shed by a source bucket
        # Deny-export hook (owner.enable_deny_export wires it): called as
        # deny_sink(cols, shed_mask, reason, now) for every shed gate so
        # shed traffic exports as event="deny" flow records, not only
        # counters.  None = the plane is off and sheds cost nothing extra.
        self.deny_sink: Optional[Callable] = None
        self.overlap = bool(overlap_commits)
        # Two-slot pending-commit ring: (finalize, staged packet-clock).
        self._staged: deque[tuple[Callable[[], None], int]] = deque()
        self.deferred_commits_total = 0
        self.epoch = 1
        self.stale = False  # bundle swapped since the last publish
        self.drains_total = 0  # published drain batches
        self.stale_reclassified_total = 0  # in-flight rows re-classified
        self.revalidations_total = 0
        self.revalidated_entries_total = 0
        self.aged_entries_total = 0
        self.drain_hist = Histogram(bounds=_DRAIN_BOUNDS)
        self._inflight: Optional[tuple[dict, int, int]] = None
        # Packet-clock bookkeeping for the epoch-age gauge: the engine sees
        # time only through the `now` its callers pass (the datapath's own
        # clock), so age is measured on that clock.
        self._published_at = 0
        self._seen_now = 0

    # -- flight recorder (the owner datapath's journal) ----------------------

    def _emit(self, kind: str, **fields) -> None:
        from ...observability.flightrec import emit_into

        emit_into(self.owner, kind, **fields)

    # -- admission (fast-step side) ------------------------------------------

    @staticmethod
    def _drop_coin(cols: dict, n: int) -> np.ndarray:
        """The per-flow early-drop coin in [0, 1<<16): a golden-ratio
        hash of the 5-tuple seeded with the per-process salt (see
        _EARLY_DROP_SALT — an unsalted coin would let an attacker craft
        flows that always shed).  Replica/depth-independent, so mesh
        callers compute it ONCE per batch and threshold per queue."""
        with np.errstate(over="ignore"):
            h = np.full(n, _EARLY_DROP_SALT, np.uint32)
            for c in ("src_ip", "dst_ip", "proto", "src_port", "dst_port"):
                h = (h ^ np.asarray(cols[c]).astype(np.uint32)) \
                    * np.uint32(0x9E3779B1)
        return (h >> np.uint32(16)) & np.uint32(0xFFFF)

    def _early_drop(self, cols: dict, mask: np.ndarray, queue: MissQueue,
                    coin: Optional[np.ndarray] = None
                    ) -> tuple[np.ndarray, int]:
        """admission="drop": shed miss admissions while `queue` is under
        pressure -> (kept mask, shed count).  Depth-proportional (linear
        from EARLY_DROP_FLOOR to a full ring) and DETERMINISTIC per flow
        — the 5-tuple hash coin, so the oracle twin sheds the identical
        lanes (parity provable under attack traffic) and a given flow's
        retries stay consistent at a given pressure level.  No-op for
        the other admission policies."""
        mask = np.asarray(mask, bool)
        if self.admission != ADMIT_DROP or not mask.any():
            return mask, 0
        lo = int(queue.capacity * EARLY_DROP_FLOOR)
        depth = queue.depth
        if depth <= lo:
            return mask, 0
        p = min(1.0, (depth - lo) / max(1, queue.capacity - lo))
        if coin is None:
            coin = self._drop_coin(cols, mask.shape[0])
        shed = mask & (coin < int(p * 65536))
        n = int(shed.sum())
        self.early_drops_total += n
        return mask & ~shed, n

    def _source_limit(self, cols: dict, mask: np.ndarray, now: int
                      ) -> np.ndarray:
        """Per-source-/24 token-bucket admission gate (see the module
        constants) -> kept mask.  Deterministic on (batch order, now):
        within a prefix, the earliest lanes take the tokens — both
        engine twins therefore shed the identical lanes.  No-op when
        miss_source_rate is unset."""
        mask = np.asarray(mask, bool)
        if self.source_rate is None or not mask.any():
            return mask
        src = np.asarray(cols["src_ip"]).astype(np.uint64)
        pfx = (src >> SOURCE_PREFIX_SHIFT).astype(np.int64)
        idx = np.nonzero(mask)[0]
        kept = mask.copy()
        now = int(now)
        shed = 0
        # Group miss lanes by prefix in O(M log M): a stable argsort of
        # the unique-inverse keeps batch order WITHIN each prefix, so the
        # earliest lanes still take the tokens (the determinism both
        # twins rely on) without rescanning the miss set per prefix.
        uniq, inv = np.unique(pfx[idx], return_inverse=True)
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(uniq.size + 1))
        swept = False   # at most ONE idle sweep per batch (amortized)
        stale = None    # lazy stalest-first order for the full-table case
        for u, p in enumerate(uniq):
            b = self._source_buckets.get(int(p))
            if b is None:
                if len(self._source_buckets) >= SOURCE_BUCKET_CAP:
                    # Evict idle (full-token) buckets first: an evicted
                    # idle bucket re-seeds at full burst, which is what
                    # it held anyway.  One sweep per batch bounds the
                    # host cost under a spoofed-prefix flood.
                    if not swept:
                        swept = True
                        for key in [k for k, v in
                                    self._source_buckets.items()
                                    if v[0] >= self.source_burst]:
                            self._source_buckets.pop(key)
                    if len(self._source_buckets) >= SOURCE_BUCKET_CAP:
                        # Every bucket is mid-interval: shed the ones
                        # refilled longest ago (stalest prefixes — under
                        # a flood, churned attack prefixes; an active
                        # source loses at most its sub-burst deficit).
                        # Rebuilt when exhausted: a batch can carry more
                        # new prefixes than one snapshot holds.
                        if not stale:
                            stale = sorted(
                                self._source_buckets,
                                key=lambda k: (self._source_buckets[k][1],
                                               k))
                        self._source_buckets.pop(stale.pop(0))
                b = self._source_buckets[int(p)] = [
                    float(self.source_burst), now]
            # Refill on the packet clock, clamped monotonic: a batch
            # carrying an older `now` must neither drive tokens negative
            # nor rewind the refill stamp (which would over-refill the
            # next in-order batch).
            dt = now - b[1]
            if dt > 0:
                b[0] = min(float(self.source_burst),
                           b[0] + dt * self.source_rate)
                b[1] = now
            lanes = idx[order[bounds[u]:bounds[u + 1]]]
            take = min(lanes.size, int(b[0]))
            b[0] -= take
            if take < lanes.size:
                kept[lanes[take:]] = False
                shed += lanes.size - take
        self.source_limited_total += shed
        return kept

    def admit(self, cols: dict, miss_mask, now: int) -> tuple[int, int]:
        """Admit the fast step's miss lanes -> (admitted, dropped)."""
        self._seen_now = max(self._seen_now, int(now))
        if self._published_at == 0:
            # Epoch age is measured from the last publish; before the
            # first one, anchor to the first traffic the engine sees so
            # the gauge reports time-since-birth, not the raw clock.
            self._published_at = int(now)
        # Per-source rate limiting runs AHEAD of the depth-proportional
        # early-drop ramp: a single scanning source is clamped by its
        # own bucket before it can push the shared queue into the ramp.
        base = np.asarray(miss_mask, bool)
        kept = self._source_limit(cols, base, now)
        if self.deny_sink is not None and kept.sum() < base.sum():
            self.deny_sink(cols, base & ~kept, "source-limit", now)
        kept2, _shed = self._early_drop(cols, kept, self.queue)
        if self.deny_sink is not None and _shed:
            self.deny_sink(cols, kept & ~kept2, "early-drop", now)
        admitted, dropped = self.queue.admit(cols, kept2, self.epoch,
                                             int(now))
        if dropped:
            self._emit("queue-overflow", dropped=int(dropped),
                       depth=int(self.queue.depth), at=int(now))
            if self.deny_sink is not None:
                # The ring keeps arrival order and tail-drops: the
                # overflowed lanes are exactly the LAST `dropped` kept
                # lanes.
                over = np.zeros(kept2.shape, bool)
                over[np.nonzero(kept2)[0][admitted:]] = True
                self.deny_sink(cols, over, "queue-overflow", now)
        return admitted, dropped

    # -- epoch plane ---------------------------------------------------------

    def _publish(self, now: int) -> None:
        self.epoch += 1
        self._published_at = int(now)
        self._seen_now = max(self._seen_now, int(now))
        self._emit("epoch-swap", epoch=int(self.epoch), at=int(now))

    def mark_stale(self, gen: int) -> None:
        """A bundle swap invalidated the current epoch: denials of older
        generations are dead to lookups already; the next drain reclaims
        them lazily and any in-flight drain re-classifies (no flush)."""
        del gen  # staleness is a flag; the owner always classifies at its CURRENT gen
        self.stale = True

    def epoch_age(self, now: Optional[int] = None) -> int:
        """Seconds (packet clock) since the last epoch publish."""
        ref = self._seen_now if now is None else int(now)
        return max(0, ref - self._published_at)

    def revalidate(self, now: int) -> int:
        """Lazy revalidation pass: reclaim stale-generation denial slots
        off the hot step, publish, clear the stale flag -> entries cleared."""
        cleared = int(self.owner._epoch_revalidate())
        self.revalidations_total += 1
        self.revalidated_entries_total += cleared
        self.stale = False
        self._publish(now)
        return cleared

    def age_scan(self, now: int) -> int:
        """Off-hot-step aging: physically reclaim idle-expired entries
        (the synchronous path leaves them to die by lookup-freshness) —
        publish via epoch swap; -> entries reclaimed."""
        reclaimed = int(self.owner._epoch_age_scan(now))
        self.aged_entries_total += reclaimed
        self._publish(now)
        return reclaimed

    def maintain(self, now: int) -> tuple[int, int]:
        """FUSED maintenance (round 6): aging + stale-generation
        revalidation in ONE pass over the cache (owner._epoch_maintain)
        instead of the two separate full-table scans revalidate() +
        age_scan() cost.  Publishes, clears the stale flag ->
        (aged, revalidated)."""
        aged, revalidated = self.owner._epoch_maintain(now)
        aged, revalidated = int(aged), int(revalidated)
        self.revalidations_total += 1
        self.revalidated_entries_total += revalidated
        self.aged_entries_total += aged
        self.stale = False
        self._publish(now)
        return aged, revalidated

    # -- drain (background side) ---------------------------------------------

    def begin_drain(self, now: int, n: Optional[int] = None) -> bool:
        """Pop one coalesced batch and pin it with its epoch + bundle
        generation; False when the queue is empty.  Split from
        finish_drain so callers (and the chaos tier) can interleave a
        bundle swap with an in-flight drain."""
        if self._inflight is not None:
            raise RuntimeError("a drain batch is already in flight")
        block = self.queue.pop(n if n is not None else self.drain_batch)
        if block is None:
            return False
        self._inflight = (block, self.epoch, int(self.owner.generation))
        self._seen_now = max(self._seen_now, int(now))
        self._emit("drain-begin", n=int(len(block["src_ip"])),
                   epoch=int(self.epoch), gen=int(self.owner.generation))
        return True

    def finish_drain(self, now: int) -> dict:
        """Classify + commit the in-flight batch and publish the new cache
        epoch.  If the bundle generation moved since begin_drain, the
        batch's pinned epoch is stale: it is re-classified under the
        CURRENT tensors (lazy revalidation of in-flight work) and counted,
        never published stale and never dropped.

        Overlapped mode: the owner's classify may return a deferred
        finalizer (host materialization + metrics of the dispatched
        drain); it is staged in the two-slot ring and the OLDEST staged
        commit retires first when the ring is full — the publish itself
        (state swap + epoch bump) still happens here, at dispatch, which
        is what makes batch N's entries visible to batch N+1."""
        if self._inflight is None:
            raise RuntimeError("no drain batch in flight")
        block, _epoch0, gen0 = self._inflight
        self._inflight = None
        k = len(block["src_ip"])
        stale = int(self.owner.generation) != gen0
        if stale:
            self.stale_reclassified_total += k
        fin = self.owner._drain_classify(block, int(now))
        if fin is not None:
            while len(self._staged) >= OVERLAP_SLOTS:
                self._retire_oldest()
            self._staged.append((fin, int(now)))
            self.deferred_commits_total += 1
        self.drains_total += 1
        self.drain_hist.observe(k)
        self._emit("drain-finish", drained=k,
                   stale_reclassified=k if stale else 0,
                   deferred=int(fin is not None))
        self._publish(now)
        return {"drained": k, "stale_reclassified": k if stale else 0}

    def _retire_oldest(self) -> None:
        fin, _staged_at = self._staged.popleft()
        fin()

    def flush_commits(self) -> int:
        """Retire every staged (deferred) drain commit -> number retired.
        Blocks on the device work those drains dispatched; after this the
        engine's metric counters are fully settled."""
        n = 0
        while self._staged:
            self._retire_oldest()
            n += 1
        return n

    @property
    def overlap_depth(self) -> int:
        return len(self._staged)

    def deferred_staleness(self) -> int:
        """Packet-clock age of the OLDEST staged commit (0 when none) —
        the observation lag the two-slot deferral buys overlap with."""
        if not self._staged:
            return 0
        return max(0, self._seen_now - self._staged[0][1])

    def _autotune_observe(self) -> None:
        """Feed the controller one decision point from the queue metrics
        (depth + overflow delta since the last decision)."""
        if self.autotuner is None:
            return
        delta = self.queue.overflows_total - self._overflows_seen
        self._overflows_seen = self.queue.overflows_total
        before = self.drain_batch
        self.drain_batch = self.autotuner.observe(self.queue.depth, delta)
        if self.drain_batch != before:
            self._emit("autotune", chunk_from=int(before),
                       chunk_to=int(self.drain_batch),
                       depth=int(self.queue.depth),
                       overflow_delta=int(delta))

    def drain(self, now: int, max_batches: Optional[int] = None) -> dict:
        """Drain the queue: heal a stale epoch first — ONE fused
        maintenance pass (aging + revalidation, round 6) instead of the
        two scans it used to take — then classify up to max_batches
        coalesced batches -> stats.  With autotuning on, the controller
        observes queue pressure once per drain() call, BEFORE popping, so
        the chosen chunk reflects the backlog this call faces."""
        stats = {"drained": 0, "batches": 0, "stale_reclassified": 0,
                 "revalidated": 0, "aged": 0}
        self._autotune_observe()
        if self.stale:
            aged, revalidated = self.maintain(now)
            stats["revalidated"] = revalidated
            stats["aged"] = aged
        while max_batches is None or stats["batches"] < max_batches:
            if not self.begin_drain(now):
                break
            one = self.finish_drain(now)
            stats["drained"] += one["drained"]
            stats["stale_reclassified"] += one["stale_reclassified"]
            stats["batches"] += 1
        return stats

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        q = self.queue
        at = self.autotuner
        return {
            "depth": q.depth,
            "capacity": q.capacity,
            "admitted_total": q.admitted_total,
            "early_drops_total": self.early_drops_total,
            "source_limited_total": self.source_limited_total,
            "overflows_total": q.overflows_total,
            "drained_total": q.drained_total,
            "drains_total": self.drains_total,
            "stale_reclassified_total": self.stale_reclassified_total,
            "revalidations_total": self.revalidations_total,
            "revalidated_entries_total": self.revalidated_entries_total,
            "aged_entries_total": self.aged_entries_total,
            "epoch": self.epoch,
            "epoch_stale": int(self.stale),
            "epoch_age_s": self.epoch_age(),
            "admission": self.admission,
            "drain_batch": self.drain_batch,
            # Overlapped-commit plane (two-slot staging; zeros when the
            # mode is off, so the scrape surface is mode-stable).
            "overlap": int(self.overlap),
            "overlap_depth": self.overlap_depth,
            "deferred_commits_total": self.deferred_commits_total,
            "deferred_staleness_s": self.deferred_staleness(),
            # Autotuner surface (chunk == drain_batch when disabled).
            "autotune": int(at is not None),
            "autotune_decisions_up": 0 if at is None else at.decisions_up,
            "autotune_decisions_down": 0 if at is None else at.decisions_down,
            # Live Histogram object (coalesced drain sizes) for the
            # metrics renderer; scalar consumers ignore it.
            "drain_hist": self.drain_hist,
        }
