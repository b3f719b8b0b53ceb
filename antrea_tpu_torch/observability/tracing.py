"""Realization tracing: per-generation span timelines across the planes.

ROADMAP item 3 holds the control plane to "end-to-end realization p99
< 1s at 10k agents" — but the only realization signal used to be ONE
histogram (`antrea_tpu_dissemination_latency_seconds`) collapsing wire,
queue-wait, compile, canary, swap and settle into a single number.  This
module is the Dapper-shaped answer: one SPAN per policy realization,
keyed by a correlation id (policy uid x spec generation x bundle commit
seq), stamped at every stage boundary as the realization flows
controller -> wire -> agent queue -> commit plane -> live traffic:

  controller   WatchEvent.ts — the commit instant, stamped by
               RamStore.apply when the event enters the dissemination
               plane (the span's origin; unstamped events — resync
               replays — are EXCLUDED and metered, never guessed);
  wire         receipt at the agent's watch callback;
  queue_wait   receipt -> the commit transaction the event rode starts
               (dirty-flag latency + install backoff — retries extend
               it, which is the honest realization latency);
  compile      the engine built + swapped the candidate tensors;
  canary       fresh-probe certification against the scalar oracle;
  swap         acceptance of the certified candidate;
  settle       durability (snapshot rotation, LKG retention);
  first_hit    the first LIVE packet batch classified under the new
               bundle generation — a cheap per-generation latch in the
               engines' step() metadata (host-side only: the compiled
               step HLO is bit-identical with tracing on or off).

Stamps are clamped monotonic at record time, so every stage duration is
>= 0 and the stage durations TELESCOPE — they sum exactly to the
end-to-end latency (first_hit - controller).  Both engines share this
tracer (the commit plane stamps are plane-level), so the span STRUCTURE
is oracle-parity by construction.

Surfaces: `antrea_tpu_policy_realization_seconds{stage}` histograms, a
bounded drop-oldest span table served at `GET /realization?uid=`
(agent/apiserver.py), `antctl realization --uid <policy>`,
`realization.json` in the support bundle, and a `realization` event in
the flight recorder per closed span.  Bookkeeping cost is budgeted by
the maintenance scheduler's `observability` task.

Step spans (StepSpans) time the data plane's hot call instead: one tree
of host spans per engine step (STEP_SPANS), from the engine's step()
through the column uploads, the pipeline walk's probe, classify (the
Service LB inside it) and commit, the read-back, the counters, the
rule-id mapping and the StepResult's assembly.  Off by default
(TpuflowDatapath.enable_step_spans turns them on); off, a span boundary
costs one `is None` check.  Under a running torch.profiler each span also
opens a record_function range of its name, spans on or off, so the
profiler's trace, which shares a clock with the device's, charges device
idle time and device work to the engine's own layers.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from .metrics import Histogram

# Stage DURATIONS of one realization span, in causal order; each is the
# gap to the previous stage's stamp (origin: the controller commit).
# analysis pass `events` asserts this tuple, the README span-stage table
# and the antrea_tpu_policy_realization_seconds registration agree.
REALIZATION_STAGES = (
    "wire", "queue_wait", "compile", "canary", "swap", "settle",
    "first_hit",
)

# Histogram label values: the stage durations plus the end-to-end total.
_HIST_STAGES = REALIZATION_STAGES + ("total",)

# Commit-plane stamp names in transaction order (tracked per commit, then
# grafted onto every span the commit realized).
_COMMIT_STAMPS = ("start", "compile", "canary", "swap", "settle")

# The spans of one engine step, each with its parent (None: the root).
# Opened by TpuflowDatapath.step / _step (engine.*) and by
# models/pipeline.py (walk.*); tests/test_torch_step_spans.py holds every
# name to a site in the source and every site to a name here.
STEP_SPANS = (
    ("engine.step", None),
    ("engine.upload", "engine.step"),
    ("engine.walk", "engine.step"),
    ("walk.probe", "engine.walk"),
    ("walk.classify", "engine.walk"),
    ("walk.lb", "walk.classify"),
    ("walk.commit", "engine.walk"),
    ("engine.readback", "engine.step"),
    ("engine.account", "engine.step"),
    ("engine.rule_ids", "engine.step"),
    ("engine.result", "engine.step"),
)


class RealizationTracer:
    """Span table + stage histograms for ONE node's realization path.

    Owned by the datapath (both engines construct one; the agent
    controller, commit plane and step latch all stamp through it).
    Single-threaded like its callers.  All tables are bounded and
    drop-oldest; drops are metered, never silent.
    """

    def __init__(self, *, span_slots: int = 256, pending_slots: int = 1024,
                 clock=time.monotonic, recorder=None):
        if span_slots <= 0 or pending_slots <= 0:
            raise ValueError(
                f"realization tracer tables must be positive, got "
                f"span_slots={span_slots} pending_slots={pending_slots}")
        self.span_slots = int(span_slots)
        self.pending_slots = int(pending_slots)
        self._clock = clock
        self._recorder = recorder
        # (uid, gen) -> span dict; three lifecycle tables, all bounded:
        # pending (stamped controller/wire, awaiting a commit), awaiting
        # (bound to a commit, awaiting first live hit), closed (the span
        # table the API serves).  OrderedDict -> drop-OLDEST on overflow.
        self._pending: OrderedDict = OrderedDict()
        self._awaiting: OrderedDict = OrderedDict()
        self._closed: OrderedDict = OrderedDict()
        self.spans_dropped_total = 0
        self.spans_closed_total = 0
        # Events that arrived without a controller stamp (resync replays):
        # excluded from the histograms, metered not guessed.
        self.unstamped_total = 0
        # The in-flight and last-completed commit transactions.
        self._open_commit: Optional[dict] = None
        self._last_commit: Optional[tuple[int, dict]] = None  # (gen, stamps)
        # First-hit latch: highest bundle generation live traffic has
        # stepped under, and when.  One int compare on the hot step.
        self._hit_gen = -1
        self._hit_at = 0.0
        # Stamp-op counter: the maintenance `observability` task reads
        # the delta as this plane's accounted cost.
        self._stamps_total = 0
        self._stamps_taken = 0
        self.hist = {s: Histogram() for s in _HIST_STAGES}
        # The most recent elastic-mesh resize span (parallel/reshard.py):
        # migrate/certify/cutover stage durations telescoping to total,
        # the realization-span shape.  One slot — resizes are rare
        # operator/autoscaler events, not a table workload.
        self.last_resize = None

    def now(self) -> float:
        return float(self._clock())

    # -- agent-side stamps ---------------------------------------------------

    def note_unstamped(self) -> None:
        """An event with no controller stamp (ts=0: resync replay /
        filestore reload) left pending work: its realization latency is
        unknowable, so it is counted out of the histograms, not guessed
        into them."""
        self.unstamped_total += 1

    def policy_event(self, uid: str, gen: int, ts: float) -> None:
        """A stamped NetworkPolicy watch event arrived at the agent:
        open (or extend) the span for (uid, spec generation).  The
        EARLIEST controller stamp wins — re-deliveries and retries must
        lengthen the span, never shorten it."""
        self._stamps_total += 1
        key = (uid, int(gen))
        t_wire = max(float(ts), self.now())
        sp = self._pending.get(key)
        if sp is None:
            old = self._awaiting.get(key)
            if old is not None:
                if float(ts) <= old["commit"]["settle"]:
                    return  # re-delivery of the realization in flight;
                    # it adds nothing
                # Stamp POSTDATES the commit that realized the old
                # lifetime: uid reuse (delete/re-add) while the old span
                # still awaits its first hit.  Retire it metered — its
                # first-hit attribution would belong to the new lifetime.
                del self._awaiting[key]
                self.spans_dropped_total += 1
            old = self._closed.get(key)
            if old is not None:
                if float(ts) <= old["closed_at"]:
                    return  # re-delivery of a realization already closed
                # Controller stamp POSTDATES the close: the controller
                # restarts spec generations at 1 after a delete/re-add,
                # so this is a NEW lifetime of the uid reusing the key.
                # Retire the old span and trace the new realization.
                del self._closed[key]
            sp = {"uid": uid, "generation": int(gen),
                  "controller_ts": float(ts), "wire_ts": t_wire}
            self._pending[key] = sp
            while len(self._pending) > self.pending_slots:
                self._pending.popitem(last=False)
                self.spans_dropped_total += 1
        else:
            sp["controller_ts"] = min(sp["controller_ts"], float(ts))

    def realized(self) -> None:
        """The agent's sync() successfully applied state: every pending
        span rode the datapath's most recent commit transaction — bind
        them to its stage stamps and start waiting for the first live
        hit on that bundle generation."""
        if not self._pending:
            return
        self._stamps_total += 1
        if self._last_commit is None:
            # No commit recorded (tracer attached mid-flight): the spans
            # cannot be stage-attributed honestly; meter them out.
            self.spans_dropped_total += len(self._pending)
            self._pending.clear()
            return
        gen, stamps = self._last_commit
        for key, sp in self._pending.items():
            sp["bundle_generation"] = int(gen)
            sp["commit"] = dict(stamps)
            self._awaiting[key] = sp
            while len(self._awaiting) > self.pending_slots:
                self._awaiting.popitem(last=False)
                self.spans_dropped_total += 1
        self._pending.clear()
        if self._hit_gen >= gen:
            # Live traffic already stepped under this (or a newer)
            # bundle: the realization is visible now.
            self._close_up_to(self._hit_gen, self._hit_at)

    # -- commit-plane stamps (datapath/commit.py) ----------------------------

    def commit_begin(self) -> None:
        """A commit transaction entered its compile stage.  queue_wait
        ends here for every span this commit realizes."""
        self._stamps_total += 1
        self._open_commit = {"start": self.now()}

    def commit_stage(self, stage: str) -> None:
        """Stamp a completed commit stage (compile/canary/swap/settle),
        clamped monotonic against the previous stamp."""
        if self._open_commit is None:
            return
        self._stamps_total += 1
        prev = max(self._open_commit.values())
        self._open_commit[stage] = max(self.now(), prev)

    def commit_done(self, gen: int) -> None:
        """The transaction settled at bundle generation `gen`: its stamps
        become the binding target for the next realized() batch."""
        oc = self._open_commit
        self._open_commit = None
        if oc is None:
            return
        self._stamps_total += 1
        # Backfill any stage a path legitimately skipped (a no-op delta
        # never swaps) so the telescoping invariant holds span-wide.
        t = oc["start"]
        for s in _COMMIT_STAMPS:
            t = oc[s] = max(oc.get(s, t), t)
        self._last_commit = (int(gen), oc)

    def commit_abort(self) -> None:
        """The transaction rolled back: nothing realized, drop the
        stamps (the retry's own transaction re-stamps from compile)."""
        self._open_commit = None

    # -- the first-hit latch (engines' step()) -------------------------------

    def first_hit(self, gen: int, batch_size: int = 0) -> None:
        """Hot-step latch: the caller is about to classify live traffic
        under bundle generation `gen`.  First call per generation stamps
        the latch and closes every span awaiting a generation <= gen;
        every later call is ONE int compare.  Pure host code — zero
        device ops, so step HLO is bit-identical with tracing disabled."""
        if gen <= self._hit_gen or batch_size <= 0:
            return
        self._stamps_total += 1
        t = self.now()
        self._hit_gen = int(gen)
        self._hit_at = t
        if self._awaiting:
            self._close_up_to(int(gen), t)

    def _close_up_to(self, gen: int, t_hit: float) -> None:
        done = [k for k, sp in self._awaiting.items()
                if sp["bundle_generation"] <= gen]
        for key in done:
            self._finish(self._awaiting.pop(key), t_hit)

    def _finish(self, sp: dict, t_hit: float) -> None:
        c = sp.pop("commit")
        # Telescoping stamp chain, clamped monotonic end to end: every
        # stage >= 0 and the stages sum EXACTLY to total.
        t0 = sp["controller_ts"]
        chain = [
            ("wire", max(sp["wire_ts"], t0)),
            ("queue_wait", c["start"]),
            ("compile", c["compile"]),
            ("canary", c["canary"]),
            ("swap", c["swap"]),
            ("settle", c["settle"]),
            ("first_hit", t_hit),
        ]
        stages, prev = {}, t0
        for name, t in chain:
            t = max(t, prev)
            stages[name] = t - prev
            prev = t
        sp["stages_s"] = stages
        sp["total_s"] = prev - t0
        sp["closed_at"] = prev
        for name, dt in stages.items():
            self.hist[name].observe(dt)
        self.hist["total"].observe(sp["total_s"])
        self.spans_closed_total += 1
        key = (sp["uid"], sp["generation"])
        self._closed[key] = sp
        self._closed.move_to_end(key)
        while len(self._closed) > self.span_slots:
            self._closed.popitem(last=False)  # drop-oldest CLOSED span:
            # served telemetry aging out of the bounded table, not loss
        if self._recorder is not None:
            self._recorder.emit(
                kind="realization", uid=sp["uid"], gen=sp["generation"],
                bundle_gen=sp["bundle_generation"],
                total_s=round(sp["total_s"], 6))

    # -- elastic-mesh resize spans (parallel/reshard.py) ---------------------

    def note_resize_span(self, span: dict) -> None:
        """Record a completed data-axis resize span so resize latency is
        measurable beside policy-realization latency (served in stats()
        as `last_resize`; the flight recorder's reshard-cutover event
        carries the same total on the journal clock)."""
        self._stamps_total += 1
        self.last_resize = dict(span)

    # -- maintenance accounting ----------------------------------------------

    def take_cost(self) -> int:
        """Stamp ops since the last take — the accounted cost the
        maintenance scheduler's `observability` task budgets."""
        d = self._stamps_total - self._stamps_taken
        self._stamps_taken = self._stamps_total
        return d

    # -- observability -------------------------------------------------------

    def spans(self, uid: Optional[str] = None) -> list[dict]:
        """Span-table rows, oldest first: closed spans plus the still
        in-flight ones (marked by state) so an operator mid-outage sees
        where a realization is STUCK, not just the ones that finished.

        Called from API handler threads while the engine thread stamps:
        a table iteration racing an insert/pop raises RuntimeError, so
        the read retries on a fresh view instead of locking the hot
        stamp path (best-effort empty after repeated conflicts)."""
        for _ in range(8):
            try:
                return self._spans_once(uid)
            except RuntimeError:
                continue
        return []

    def _spans_once(self, uid: Optional[str]) -> list[dict]:
        out = []
        for state, table in (("pending", self._pending),
                             ("awaiting_first_hit", self._awaiting),
                             ("closed", self._closed)):
            for sp in table.values():
                row = dict(sp)
                row.pop("commit", None)
                row["state"] = state
                out.append(row)
        if uid is not None:
            out = [r for r in out if r["uid"] == uid]
        return out

    def stats(self) -> dict:
        return {
            "stages": list(REALIZATION_STAGES),
            "pending": len(self._pending),
            "awaiting_first_hit": len(self._awaiting),
            "closed": len(self._closed),
            "span_slots": self.span_slots,
            "spans_closed_total": int(self.spans_closed_total),
            "spans_dropped_total": int(self.spans_dropped_total),
            "unstamped_total": int(self.unstamped_total),
            "first_hit_generation": int(self._hit_gen),
            "p99_s": (self.hist["total"].quantile(0.99)
                      if self.hist["total"].count else None),
            "last_resize": self.last_resize,
        }


# -- step spans ----------------------------------------------------------------


class _Slot(threading.local):
    """The recorder of the step running on this thread (None: spans off).
    The engine sets it for the length of a step; the pipeline's functions,
    which have no engine handle, read it.  Per thread, so a mesh engine's
    rule-shard threads see None."""

    sp = None


SLOT = _Slot()

_profiler = None


def profiling() -> bool:
    """Whether a torch.profiler session is recording (torch is imported
    on the first call, never at import)."""
    global _profiler
    if _profiler is None:
        import torch.autograd.profiler as prof

        _profiler = prof
    return _profiler._is_profiler_enabled


class StepSpans:
    """Host spans of an engine's steps: per-name totals and a bounded
    drop-oldest ring of the most recent span records.

    A step is begin(t0) ... end(t1) around enter(name) / leave() pairs
    that nest; every span of a step carries the step's sequence number.
    A record is (seq, name, parent, start_ns, end_ns) on the
    time.perf_counter_ns clock; the totals per name are its count, total
    seconds and self seconds (its duration less its children's).
    Nothing is written anywhere: the caller reads stats() / records().
    Single-threaded like the engine's step."""

    def __init__(self, slots: int = 4096):
        if slots <= 0:
            raise ValueError(f"step span slots must be positive, got {slots}")
        self.slots = int(slots)
        self._ring: deque = deque(maxlen=self.slots)
        self.dropped_total = 0
        self.steps = 0
        # name -> [count, total ns, self ns]
        self._totals: dict = {n: [0, 0, 0] for n, _ in STEP_SPANS}
        # Open spans, innermost last: [name, start ns, children's ns,
        # the profiler range or None].
        self._stack: list = []

    def _open(self, name: str, t0: int) -> None:
        rf = None
        if profiling():
            import torch

            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
        self._stack.append([name, t0, 0, rf])

    def _close(self, t1: int) -> None:
        name, t0, child, rf = self._stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        dur = t1 - t0
        parent = None
        if self._stack:
            top = self._stack[-1]
            top[2] += dur
            parent = top[0]
        tot = self._totals[name]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - child
        if len(self._ring) == self.slots:
            self.dropped_total += 1
        self._ring.append((self.steps, name, parent, t0, t1))

    def begin(self, t0: int) -> None:
        """A step starts at t0 (perf_counter_ns): open its root span."""
        self.steps += 1
        self._open("engine.step", t0)

    def enter(self, name: str) -> None:
        self._open(name, time.perf_counter_ns())

    def leave(self) -> None:
        self._close(time.perf_counter_ns())

    def end(self, t1: int) -> None:
        """The step ends at t1: close the root, and any span an exception
        left open, there."""
        while self._stack:
            self._close(t1)

    def records(self) -> list:
        """The ring's span records, oldest first."""
        return list(self._ring)

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "slots": self.slots,
            "records": len(self._ring),
            "dropped_total": self.dropped_total,
            "spans": {n: {"count": c, "total_s": t * 1e-9,
                          "self_s": s * 1e-9}
                      for n, (c, t, s) in self._totals.items()},
        }
