"""Flight recorder: a black-box event journal for every plane transition.

The reference debugs its datapath with OVS's own introspection (coverage
counters, `ovs-appctl` dumps); this build owns the datapath, so it must
own the post-mortem story too.  PRs 4-7 grew plane transitions — rollback
to last-known-good, degraded mode, epoch swaps, autotune rung moves,
maintenance sheds — that left no record at all: a chaos test could assert
the FINAL state but never the PATH taken, and an operator staring at a
degraded node had counters, not causality.

`FlightRecorder` is the in-memory ring journal (the classic black-box
shape: bounded, always on, cheap enough to leave running):

  * fixed capacity, preallocated slots, DROP-OLDEST on wrap — recording
    is one dict store + two int bumps, it never blocks, backpressures, or
    reorders the hot step; overflow loses the OLDEST telemetry, metered
    in `dropped_total`, never the newest;
  * every event carries a MONOTONIC sequence number (the causal order —
    two events' seq ordering is their emission ordering) and a timestamp
    from the maintenance tick clock (`MaintenanceScheduler.clock`),
    so fault-injected time (dissemination/faults.FaultClock) stamps the
    journal deterministically in the chaos tier;
  * events are TYPED: `emit(kind=...)` accepts only kinds declared in
    EVENT_KINDS below — tools/check_events.py fails the build on an
    undeclared kind at any call site, a declared kind with no emit site,
    or a kind missing its README row.

Emit sites (one per plane transition, threaded through):
  datapath/commit.py        commit stage outcomes, canary mismatches,
                            rollback, degrade, recover
  datapath/slowpath/        epoch swaps, drain begin/finish, queue
                            overflow, autotune rung moves
  datapath/maintenance.py   per-tick grants/sheds, blocked ticks
  datapath/audit.py         findings, repairs
  agent/controller.py       sync attempts, poison-bundle quarantine
  dissemination/faults.py   every injected fault logs itself, so a chaos
                            post-mortem correlates cause with effect
  observability/tracing.py  realization span closures

Surfaces: `GET /flightrecorder?tail=N[&kind=...]` (agent/apiserver.py),
`antctl flightrecorder [--tail N] [--kind ...]`, `flightrecorder.json` in
the support bundle, and the antrea_tpu_flightrecorder_events_total /
antrea_tpu_flightrecorder_dropped_total / antrea_tpu_flightrecorder_seq
metric families.
Recording cost is accounted by the maintenance scheduler's
`observability` task (datapath/maintenance.py) instead of smearing into
whichever plane happened to emit.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional

# The typed event schema: kind -> emitting plane + meaning.  Pure
# literals on purpose — tools/check_events.py parses this dependency-free
# and fails the build when an emit site uses an undeclared kind, a
# declared kind has no emit site, or a kind has no README row.
EVENT_KINDS = {
    "commit": "datapath/commit.py — one install transaction settled or "
              "failed (stage carries the deciding stage, outcome "
              "ok/error/mismatch)",
    "canary-mismatch": "datapath/commit.py — canary probes diverged from "
                       "the scalar oracle (install gate or live watchdog)",
    "rollback": "datapath/commit.py — state restored to the retained "
                "last-known-good bundle",
    "degrade": "datapath/commit.py + datapath/audit.py — the datapath "
               "entered degraded mode (serving LKG, deltas quarantined)",
    "recover": "datapath/commit.py — a full-bundle recompile passed its "
               "canary and lifted degraded mode",
    "epoch-swap": "datapath/slowpath/engine.py — a new flow-cache epoch "
                  "published (drain commit, revalidation or aging pass)",
    "drain-begin": "datapath/slowpath/engine.py — a coalesced miss batch "
                   "popped and pinned (epoch + bundle generation)",
    "drain-finish": "datapath/slowpath/engine.py — the in-flight batch "
                    "classified and committed (stale batches re-classify)",
    "queue-overflow": "datapath/slowpath/engine.py — miss admissions "
                      "tail-dropped on a full queue",
    "autotune": "datapath/slowpath/engine.py — the drain-chunk hysteresis "
                "controller moved one ladder rung",
    "maint-tick": "datapath/maintenance.py — one scheduler round: per-task "
                  "grants, deferrals and sheds",
    "maint-blocked": "datapath/maintenance.py — a tick deferred whole by "
                     "the serialization point (in-flight drain)",
    "audit-finding": "datapath/audit.py — a revalidator scan found "
                     "divergences (cached rows or tensor digests)",
    "audit-repair": "datapath/audit.py — divergent rows evicted for lazy "
                    "reclassify / corrupt tensors healed",
    "agent-sync": "agent/controller.py — a sync() applied state to the "
                  "datapath, or the install raised (outcome + error)",
    "agent-quarantine": "agent/controller.py — a deterministic compile "
                        "rejection poisoned the bundle (no hot retry "
                        "until new upstream state)",
    "fault-injected": "dissemination/faults.py — a FaultPlan rule fired "
                      "(site, fault kind, hit count): chaos cause, "
                      "journaled beside its effects",
    "mesh-epoch-swap": "parallel/meshpath.py — the mesh datapath "
                       "published a new flow-cache epoch: one sharded "
                       "dispatch + one epoch counter flips every data "
                       "replica's generation atomically (the mesh-wide "
                       "swap)",
    "replica-canary-veto": "datapath/commit.py — a replica-resolved "
                           "canary found >= 1 data replica diverging "
                           "from the scalar oracle; the single veto "
                           "rolls back / degrades ALL replicas",
    "realization": "observability/tracing.py — a policy realization span "
                   "closed (controller commit -> first live hit)",
    "prune-retune": "datapath/tpuflow.py — the match-prune K-budget "
                    "hysteresis controller moved one PRUNE_LADDER rung "
                    "(fed by the measured fallback rate)",
    "reshard-begin": "parallel/reshard.py — a live data-axis resize "
                     "started: target mesh constructed, dual-topology "
                     "serving begins (the old affinity ring keeps "
                     "serving while migration runs)",
    "reshard-migrated": "parallel/reshard.py — the budgeted migration "
                        "cursor covered the whole source slot space; "
                        "the plane is ready to certify and cut over",
    "reshard-cutover": "parallel/reshard.py — the target topology passed "
                       "its replica-resolved canary + migrated-row audit "
                       "and the affinity hash flipped generation in one "
                       "mesh-wide epoch swap",
    "reshard-abort": "parallel/reshard.py — the resize aborted "
                     "(target-topology canary veto, audit divergence, "
                     "flip failure, or operator abort): the old mesh "
                     "keeps serving, generation unchanged",
    "tenant-create": "datapath/tenancy.py — an isolated tenant policy "
                     "world was created (rung-padded rule window, "
                     "quota-rung state tables, generation 0)",
    "tenant-quota-clamp": "datapath/tenancy.py — a tenant's miss-queue "
                          "admissions were clamped to its in-queue "
                          "quota (noisy-neighbor containment; the "
                          "clamped flows re-admit once its backlog "
                          "drains)",
    "tenant-rollback": "datapath/tenancy.py — a tenant's install failed "
                       "its transaction (canary veto / compile fault) "
                       "and rolled back ONLY that tenant's world; every "
                       "other tenant's generation is untouched",
    "tenant-reshard-cutover": "parallel/reshard.py — one tenant world's "
                              "state flipped to the target topology: its "
                              "own replica-resolved canary + migrated-row "
                              "audit certified the placement and its rows "
                              "re-homed under the tenant-salted ring",
    "tenant-reshard-veto": "parallel/reshard.py — one tenant world's "
                           "target-placement certification failed "
                           "(canary veto / audit divergence / placement "
                           "fault): ONLY that world aborted and keeps "
                           "serving its old topology via the per-world "
                           "generation latch; certified worlds still "
                           "flip",
    "watcher-overflow": "dissemination/store.py — distinct-key churn "
                        "filled a bounded watcher queue past max_pending "
                        "even after coalescing: the buffer dropped and "
                        "the stream flipped to needs_resync",
    "resync-begin": "dissemination/netwire.py — the server opened a "
                    "resync window for a node (objects = snapshot size; "
                    "restart=True when a mid-resync overflow re-listed "
                    "inside the same window)",
    "resync-end": "dissemination/netwire.py — a node's resync window "
                  "closed (chunks + events actually shipped after "
                  "known-set dedup)",
    "resync-shed": "dissemination/netwire.py — the admission gate "
                   "deferred a watcher's resync because "
                   "resync_concurrency cursors were already in flight",
    "perf-regression": "observability/telemetry.py — the telemetry "
                       "sentinel found a regime's rolling-window p99 "
                       "burning past ratio x its rolling baseline "
                       "(payload: regime, p99, baseline_p99, samples, "
                       "ratio) — journal-and-meter only, never an "
                       "automatic rollback",
    "batch-flush": "serving/batcher.py — a staging ring flushed onto the "
                   "canonical batch ladder (payload: tenant, lanes, "
                   "padded, dispatches, age_ticks, reason = depth / "
                   "deadline / forced / overflow)",
    "batch-deadline-exceeded": "serving/batcher.py — a ring flushed "
                               "LATER than its flush_deadline (budget "
                               "starvation or a stalled tick clock): "
                               "the p99 contract was at risk for that "
                               "world's staged lanes",
    "replica-probe-fail": "parallel/failover.py — a data replica failed "
                          "one health probe round (payload: replica, "
                          "reason = mismatch / deadline / fault-dead, "
                          "streak); probe_fails consecutive failures "
                          "quarantine the replica",
    "replica-quarantine": "parallel/failover.py — a replica was "
                          "quarantined: masked out of serving "
                          "immediately (lanes re-home onto the survivor "
                          "ring host-side), its queued misses requeued "
                          "verbatim to survivors, and the ring "
                          "evacuation begins",
    "replica-evacuate": "parallel/failover.py — the emergency shrink to "
                        "the survivor topology CUT OVER "
                        "(canary-certified like every resize): survivor "
                        "rows migrated, the dead replica's flows "
                        "re-miss and re-classify to identical verdicts "
                        "(payload meters the re-miss burst)",
    "replica-readmit": "parallel/failover.py — the quarantined replica "
                       "rejoined (payload: mode = auto / operator, gate "
                       "= unmask for a pre-flip heal, resize for the "
                       "certified grow back over the boot device grid)",
}


def emit_into(carrier, kind: str, **fields) -> None:
    """Journal one event into `carrier`'s flight recorder, a no-op when
    it has none — the ONE null-recorder discipline every plane's `_emit`
    shim delegates to (the shims keep the literal kind at their call
    sites, which is what tools/check_events.py greps)."""
    rec = getattr(carrier, "_flightrec", None)
    if rec is not None:
        rec.emit(kind=kind, **fields)


class FlightRecorder:
    """Fixed-capacity, drop-oldest ring journal of typed events.

    Single-threaded like every plane that feeds it (the engines' control
    thread); `emit` is append-only into preallocated slots.  `capacity=0`
    disables recording entirely (emit becomes a counter bump only), so
    the journal can be compiled out of soak runs without touching any
    emit site.
    """

    def __init__(self, capacity: int = 1024,
                 clock: Optional[Callable[[], int]] = None):
        if capacity < 0:
            raise ValueError(
                f"flight recorder capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._slots: list = [None] * self.capacity
        # Monotonic sequence number == events emitted since boot; the
        # ring keeps the LAST `capacity` of them.
        self.seq = 0
        self.dropped_total = 0
        self.emitted: Counter = Counter()  # kind -> count (survives wrap)
        self._clock = clock

    def set_clock(self, clock: Callable[[], int]) -> None:
        """Wire the timebase — the maintenance scheduler's tick clock
        (datapath/maintenance.py `_init_maintenance` calls this), so the
        journal, the backoff windows and FQDN expiry share ONE notion of
        now, fault-injectable via faults.FaultClock."""
        self._clock = clock

    def _now(self) -> int:
        return 0 if self._clock is None else int(self._clock())

    def emit(self, kind: str, **fields) -> int:
        """Journal one event -> its sequence number.  O(1), allocation
        bounded to the event dict itself: never blocks the hot step;
        on a full ring the OLDEST slot is overwritten (metered)."""
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"undeclared flight-recorder event kind {kind!r} "
                f"(declare it in observability/flightrec.EVENT_KINDS)")
        seq = self.seq
        self.seq += 1
        self.emitted[kind] += 1
        if self.capacity == 0:
            self.dropped_total += 1  # disabled: every event is "lost"
            return seq
        i = seq % self.capacity
        if self._slots[i] is not None:
            self.dropped_total += 1
        self._slots[i] = {"seq": seq, "ts": self._now(), "kind": kind,
                          **fields}
        return seq

    # -- reading the journal -------------------------------------------------

    def events(self, tail: Optional[int] = None,
               kind: Optional[str] = None) -> list[dict]:
        """Journal contents in sequence order (oldest retained first);
        `kind` filters, `tail` keeps the last N AFTER filtering."""
        if self.capacity == 0:
            return []
        # API handler threads read while the engine thread emits: snapshot
        # the head, then keep only slots whose seq matches the window —
        # a slot overwritten mid-read carries a NEWER seq and is skipped
        # (drop-oldest semantics), so the result is always in sequence
        # order and never torn.
        snap = self.seq
        start = max(0, snap - self.capacity)
        out = []
        for s in range(start, snap):
            e = self._slots[s % self.capacity]
            if e is not None and e["seq"] == s:
                out.append(e)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        if tail is not None:
            n = max(0, int(tail))
            out = out[-n:] if n else []  # -0 would slice the WHOLE list
        return out

    def stats(self) -> dict:
        return {
            "capacity": int(self.capacity),
            "seq": int(self.seq),
            "retained": min(self.seq, self.capacity),
            "dropped_total": int(self.dropped_total),
            "kinds": {k: int(v) for k, v in sorted(self.emitted.items())},
        }
