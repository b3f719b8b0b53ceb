"""Hot-path telemetry plane: in-kernel counters, regime-classified step
histograms, and the perf-regression sentinel.

The reference treats its datapath as a black box it can only poll from
outside (conntrack dumps via pkg/agent/flowexporter); this build OWNS the
datapath, so the kernel itself is instrumented: with
PipelineMeta.telemetry set, every step emits cheap counter outputs —
cache probe hit/stale/miss splits, DMA half-blocks issued by the
one-pass kernel, second-chance protection bumps — derived XLA-side from
values the step already gathers (models/pipeline.py tel_* keys), and
`telemetry=False` lowers to HLO bit-identical with the uninstrumented
step.  `TelemetryPlane` is the host-side accumulator both engines and
the mesh datapath mix in:

  * counters: one monotonic total per TELEMETRY_COUNTERS name, fed from
    the step's tel_* outputs (per-replica vectors sum — the counters are
    replica-additive by construction);
  * regime histograms: each batch classifies into ONE traffic regime
    from its own outputs (classify_regime below), and the step's wall
    seconds fold into a per-(scope, regime) Histogram — scope "engine"
    always, "replicaN" on the mesh, "tenant:X" where worlds exist — so
    production answers "what is my cold-regime p99 right now" without a
    bench run;
  * the sentinel: a budgeted maintenance sweep (MAINT_TASKS
    `telemetry-sentinel`, clocked by the scheduler tick so FaultClock
    drives it deterministically) compares each regime's current-window
    p99 against a rolling baseline and reports a regression when the
    window burns past ratio x baseline — journal-and-meter ONLY
    (flightrec kind `perf-regression`), never an automatic rollback.
    Regressed windows are quarantined from the baseline so a sustained
    slowdown keeps firing instead of normalizing itself away.

Failure model: everything here is bounded host-side state — histograms
are fixed buckets, pendings are cleared every step — and overflow
anywhere in the observability plane is drop-oldest (flightrec ring),
never backpressure on the hot step.

Surfaces: `GET /telemetry` (agent/apiserver.py), `antctl telemetry`,
`telemetry.json` in the support bundle, the telemetry metric families
(metrics.render_metrics — one counter family per name here, the regime
histogram, the regression meter), and bench.py's `steady_telemetry_pps`
overhead line.
"""

from __future__ import annotations

import numpy as np

from .metrics import Histogram

# The kernel counter schema: names of the tel_* outputs the instrumented
# step emits (models/pipeline.py).  Pure literal on purpose —
# analysis/telemetry.py parses this dependency-free and fails the build
# when the kernel outputs, the TelemetryPlane accumulators, the metric
# families or the README rows drift from it.
TELEMETRY_COUNTERS = (
    "probe_hit",
    "probe_stale",
    "probe_miss",
    "chance_bumps",
    "dma_hb",
)

# Traffic regimes a batch can classify into (classify_regime), in
# sentinel sweep order.  Pure literal for the same drift gate.
REGIMES = (
    "steady",
    "cold",
    "churn",
    "drain",
    "attack-shed",
)


def classify_regime(batch: int, n_miss: int, shed: int = 0) -> str:
    """One regime per batch, decided from the batch's OWN outputs — no
    history, so the kernel twin and the scalar oracle classify
    identically on the same step sequence.  Precedence:

      attack-shed  the slow-path engine shed traffic since the last
                   batch (early-drop, per-source bucket, or queue
                   overflow): the node is under admission pressure
      cold         >= half the batch missed the flow cache (boot,
                   post-epoch-swap, or a cache flush)
      churn        some lanes missed (new flows arriving under load)
      steady       every lane hit — the throughput regime the fused
                   default-flip decision needs numbers for

    The fifth regime, "drain", never classifies from a step: coalesced
    slow-path drains fold their own wall seconds in directly
    (TelemetryPlane.observe_scoped), since a drain is its own dispatch,
    not a property of a traffic batch."""
    if shed > 0:
        return "attack-shed"
    if n_miss <= 0:
        return "steady"
    if 2 * int(n_miss) >= int(batch):
        return "cold"
    return "churn"


class TelemetryPlane:
    """Host-side accumulator for the hot-path telemetry tentpole.

    Single-threaded like every plane that feeds it (the engines' control
    thread).  The per-step protocol is two calls: `note_regime` during
    `_step` for each scope the batch classifies under (the engine always,
    replicas/tenants when they exist), then `observe_step(dt)` from the
    step's timing bracket — the pending scopes fold the SAME wall
    seconds, then clear, so an exception between the two loses at most
    one observation and never corrupts state."""

    def __init__(self, min_samples: int = 16, ratio: float = 2.0):
        if min_samples <= 0:
            raise ValueError(
                f"telemetry min_samples must be > 0, got {min_samples}")
        if ratio <= 1.0:
            raise ValueError(
                f"sentinel ratio must exceed 1.0 (a threshold at or "
                f"below the baseline always fires), got {ratio}")
        self.min_samples = int(min_samples)
        self.ratio = float(ratio)
        self.counters: dict[str, int] = {n: 0 for n in TELEMETRY_COUNTERS}
        self.steps_total = 0
        self.regressions_total = 0
        self.sweeps_total = 0
        # (scope, regime) -> step-seconds Histogram; scopes appear on
        # first observation so a single-chip engine carries no replica
        # rows and a world-free engine no tenant rows.
        self._hists: dict[tuple[str, str], Histogram] = {}
        # Sentinel state, engine-scope only (one verdict per regime per
        # node): the current window and the rolling baseline it rolls
        # into once judged.
        self._wins: dict[str, Histogram] = {r: Histogram() for r in REGIMES}
        self._base: dict[str, Histogram] = {r: Histogram() for r in REGIMES}
        self._cursor = 0  # round-robin regime cursor for budgeted sweeps
        self._pending: list[tuple[str, str]] = []
        self._shed_seen = 0

    # -- feeding the plane ---------------------------------------------------

    def account(self, out: dict) -> None:
        """Fold one step's tel_* counter outputs.  Values may be scalars
        (single chip) or per-replica vectors (mesh dispatch) — the
        counters are additive across replicas, so everything sums."""
        for name in TELEMETRY_COUNTERS:
            v = out.get("tel_" + name)
            if v is not None:
                self.counters[name] += int(np.asarray(v).sum())

    def note_shed(self, shed_total: int) -> int:
        """Delta the slow-path engine's cumulative shed meters (early
        drops + source-limit + queue overflows) against the last batch's
        view -> sheds attributable to THIS batch (the attack-shed
        classification input)."""
        d = int(shed_total) - self._shed_seen
        self._shed_seen = int(shed_total)
        return max(0, d)

    def note_regime(self, scope: str, regime: str) -> None:
        """Queue one (scope, regime) classification for the step's
        timing bracket to fold (observe_step)."""
        if regime not in self._wins:
            raise ValueError(f"unknown telemetry regime {regime!r}")
        self._pending.append((scope, regime))

    def observe_step(self, dt: float) -> None:
        """Fold the step's wall seconds into every pending (scope,
        regime) histogram; engine-scope observations additionally feed
        the sentinel's current window."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        self.steps_total += 1
        for scope, regime in pending:
            self._hist(scope, regime).observe(dt)
            if scope == "engine":
                self._wins[regime].observe(dt)

    def observe_scoped(self, scope: str, regime: str, dt: float) -> None:
        """Immediate-mode fold for dispatches that own their timing —
        coalesced slow-path drains fold their wall seconds into the
        "drain" regime here, outside any step bracket."""
        if regime not in self._wins:
            raise ValueError(f"unknown telemetry regime {regime!r}")
        self._hist(scope, regime).observe(dt)
        if scope == "engine":
            self._wins[regime].observe(dt)

    def _hist(self, scope: str, regime: str) -> Histogram:
        h = self._hists.get((scope, regime))
        if h is None:
            h = self._hists[(scope, regime)] = Histogram()
        return h

    # -- the sentinel --------------------------------------------------------

    def sentinel_sweep(self, budget: int) -> tuple[int, list[dict]]:
        """One budgeted sweep: judge up to `budget` regimes (round-robin
        cursor, so every regime is reached across ticks) -> (n_checked,
        regression events).  A regime is judged only once BOTH its
        current window and its baseline carry min_samples observations;
        a clean window rolls into the baseline (the rolling-baseline
        fold), a regressed window is quarantined — dropped, not merged —
        so a sustained slowdown keeps firing instead of normalizing
        itself into the baseline.  The caller journals the events
        (flightrec `perf-regression`); this plane never acts on them —
        journal-and-meter only, by design."""
        events: list[dict] = []
        checked = 0
        for _ in range(max(0, min(int(budget), len(REGIMES)))):
            regime = REGIMES[self._cursor % len(REGIMES)]
            self._cursor += 1
            checked += 1
            win = self._wins[regime]
            if win.count < self.min_samples:
                continue
            base = self._base[regime]
            regressed = False
            if base.count >= self.min_samples:
                p99 = win.quantile(0.99)
                bp99 = base.quantile(0.99)
                regressed = bp99 > 0 and p99 > self.ratio * bp99
                if regressed:
                    self.regressions_total += 1
                    events.append({
                        "regime": regime,
                        "p99": float(p99),
                        "baseline_p99": float(bp99),
                        "samples": int(win.count),
                        "ratio": self.ratio,
                    })
            if not regressed:
                base.merge(win)
            self._wins[regime] = Histogram()
        self.sweeps_total += 1
        return checked, events

    # -- reading the plane ---------------------------------------------------

    def stats(self) -> dict:
        """JSON-able snapshot: the counter totals, per-scope per-regime
        step latency summaries, and the sentinel's window/baseline
        state — the one payload GET /telemetry, antctl and the support
        bundle all serve."""
        regimes: dict[str, dict] = {}
        for (scope, regime), h in sorted(self._hists.items()):
            if not h.count:
                continue
            regimes.setdefault(scope, {})[regime] = {
                "count": int(h.count),
                "sum_seconds": float(h.sum),
                "p50_seconds": float(h.quantile(0.5)),
                "p99_seconds": float(h.quantile(0.99)),
            }
        return {
            "counters": {n: int(v) for n, v in self.counters.items()},
            "steps_total": int(self.steps_total),
            "regressions_total": int(self.regressions_total),
            "sweeps_total": int(self.sweeps_total),
            "regimes": regimes,
            "sentinel": {
                r: {
                    "window_samples": int(self._wins[r].count),
                    "baseline_samples": int(self._base[r].count),
                    "baseline_p99_seconds":
                        float(self._base[r].quantile(0.99)),
                }
                for r in REGIMES
            },
            "config": {
                "min_samples": self.min_samples,
                "ratio": self.ratio,
            },
        }

    def hist_rows(self, node: str) -> list[tuple[str, dict, Histogram]]:
        """(family, labels, Histogram) rows for metrics._render_histograms
        — one antrea_tpu_telemetry_regime_step_seconds series per live
        (scope, regime)."""
        return [
            ("antrea_tpu_telemetry_regime_step_seconds",
             {"scope": scope, "regime": regime, "node": node}, h)
            for (scope, regime), h in sorted(self._hists.items())
            if h.count
        ]
