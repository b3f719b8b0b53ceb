"""Unified maintenance scheduler: ONE budgeted background plane.

The reference datapath keeps itself healthy with a dedicated revalidator
plane — ovs-vswitchd's udpif revalidator threads sweep, re-prove and
reclaim megaflows on a budget, off the packet hot path (ofproto/
ofproto-dpif-upcall.c; the reference agent only *programs* that
datapath).  This build had grown five such loops ad hoc, each with its
own cadence and its own race against drains and epoch swaps:

  canary_scan                live-bundle watchdog (datapath/commit.py)
  audit cursor + scrub       continuous revalidator (datapath/audit.py)
  maintain/age_scan          flow-cache aging + lazy revalidation
                             (datapath/slowpath/engine.py)
  FQDN TTL GC                agent/fqdn.py timer loop
  degraded recompile         backoff-paced recovery (agent/controller.py)

This module consolidates them behind one scheduler (ROADMAP item 5 —
the refactor that makes the multichip port touch ONE scheduler instead
of five loops, and that retires the pairwise plane-vs-plane interleaving
tests test_cache_audit.py used to enumerate by hand):

  * every loop registers a `MaintenanceTask` with a declared budget
    (rows / probes / passes per tick) and a priority;
  * `MaintenanceScheduler.tick(now, budget)` is the ONLY entry point
    that runs them (analysis pass `maintenance` fails the build on a
    direct `canary_scan`/`audit_scan`/`maintain` call site outside this
    module or the tests) — deficit-round-robin across tasks,
    budget-clamped, starvation-free (a task deferred for
    `starvation_ticks` consecutive ticks is boosted to the front);
  * ONE serialization point: a tick never runs concurrently with an
    in-flight drain (`begin_drain`..`finish_drain` defers the whole
    tick, metered as a blocked tick), staged overlapped drain commits
    are retired before any task touches the cache, and a stale epoch
    promotes the cache-maintain task to the front so the fused heal
    lands before audits walk the cache;
  * priority inversion under degradation: while the commit plane is
    degraded, `degraded-recompile` and `canary` run first and cosmetic
    work (`tensor-scrub`) is shed, metered;
  * the scheduler owns the monotonic tick clock every plane consults
    (FQDN TTL expiry, the recompile backoff), so fault-injected time
    (dissemination/faults.FaultClock) drives every plane
    deterministically.

Observability: `maintenance_stats()` (scraped as
antrea_tpu_maintenance_ticks_total through
antrea_tpu_maintenance_scheduler_lag), the agent API's GET /maintenance
route, `antctl maintenance`, and the profiler's maintenance mode
(models/profile.MAINT_PHASE_CHAIN, `profile(mode="maintenance")`,
`bench_profile.py --mode maintenance`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..config import ConfigError
from .audit import SCRUB_MANIFEST

# Task inventory: name -> owning plane.  Pure literals on purpose —
# analysis pass `maintenance` parses this table dependency-free and fails
# the build when a registered task is missing or an off-hot-step loop
# grows a call site outside the scheduler.
MAINT_TASKS = {
    "degraded-recompile": "datapath/commit.py (run_bundle, backoff-paced)",
    "canary": "datapath/commit.py (live-bundle canary watchdog)",
    "cache-maintain": "datapath/slowpath/engine.py (fused age+revalidate)",
    "audit-cursor": "datapath/audit.py (cursor cache revalidation)",
    "tensor-scrub": "datapath/audit.py (device-tensor checksum scrub)",
    "fqdn-ttl": "agent/fqdn.py (DNS-learned membership TTL GC)",
    "observability": "observability/flightrec.py + tracing.py (journal/"
                     "span bookkeeping, cost-accounted not smeared)",
    "reshard-migrate": "parallel/reshard.py (budgeted drain-and-migrate of "
                       "flow-cache rows to their target-topology home "
                       "shards; the grant splits evenly across the "
                       "default world and every live tenant world, each "
                       "migrated under its own _world_ctx; registered by "
                       "the mesh engine only while a live data-axis "
                       "resize is in flight)",
    "tenant-maintain": "datapath/tenancy.py (fused age+revalidate of one "
                       "tenant world per granted unit, rotating over "
                       "worlds; registered on first tenant_create only — "
                       "untenanted engines keep the original task set)",
    "telemetry-sentinel": "observability/telemetry.py (budgeted rolling "
                          "p99-vs-baseline regime sweep; journals "
                          "perf-regression, never acts — registered only "
                          "on telemetry=True engines)",
    "serving-flush": "serving/batcher.py (depth-OR-deadline flush of the "
                     "per-world staging rings onto the canonical batch "
                     "ladder, DRR-fair with starvation aging; registered "
                     "when the serving batcher materializes — unbatched "
                     "engines keep the original task set)",
    "replica-health": "parallel/failover.py (per-replica canary health "
                      "probes + quarantine/evacuation/readmission state "
                      "machine; registered on failover=True mesh engines "
                      "only, and NEVER shed when degraded — a degraded "
                      "mesh is exactly when replica loss must be seen)",
}

# A starved task's deficit keeps accumulating so it can eventually afford
# its minimum cost, but is capped so an idle task cannot bank an
# unbounded burst.
DEFICIT_CAP_TICKS = 16

# Consecutive deferred ticks before a task is boosted to the front of the
# next tick regardless of priority (the starvation-freedom guarantee).
STARVATION_TICKS = 8

# Degraded-recompile pacing (tick-clock units): capped exponential.
RECOMPILE_BACKOFF_CAP = 64


@dataclass
class MaintenanceTask:
    """One registered background loop.

    `run(now, budget) -> units spent` must honor `budget` (rows, probes,
    passes — the task's own unit); returning 0 means it had nothing to do
    at this budget.  `min_cost` is the smallest budget the task can act
    on (e.g. one full canary probe batch) — the scheduler defers it,
    deficit accumulating, until the deficit affords it.  `priority`
    orders tasks within a tick (lower first); `degraded_priority`
    replaces it while the commit plane is degraded, and
    `shed_when_degraded` sheds the task entirely then (cosmetic work)."""

    name: str
    run: Callable[[int, int], int]
    budget: int
    priority: int = 5
    min_cost: int = 1
    degraded_priority: Optional[int] = None
    shed_when_degraded: bool = False

    def __post_init__(self):
        if int(self.budget) <= 0:
            raise ConfigError(
                f"maintenance task {self.name!r}: budget must be positive, "
                f"got {self.budget} (a zero/negative budget would silently "
                f"starve the task; unregister it instead)"
            )
        if int(self.min_cost) <= 0:
            raise ConfigError(
                f"maintenance task {self.name!r}: min_cost must be "
                f"positive, got {self.min_cost}"
            )


@dataclass
class _TaskState:
    task: MaintenanceTask
    deficit: int = 0
    starved: int = 0  # consecutive deferred ticks (starvation aging)
    runs_total: int = 0
    spent_total: int = 0
    deferrals_total: int = 0
    shed_total: int = 0
    overruns_total: int = 0
    last_ran_at: int = field(default=-1)
    # Last tick the task was GRANTED at least its min cost (it had its
    # chance, whether or not it had work) — the lag gauge's reference,
    # so an inert-but-granted task (recompile while healthy) reads 0 lag.
    last_granted_at: int = field(default=-1)


class MaintenanceScheduler:
    """Deficit-round-robin scheduler over the registered maintenance
    tasks of ONE datapath.  Single-threaded by construction, like every
    plane it consolidates: callers invoke `tick()` from the same control
    thread that drives drains and installs, and the tick itself enforces
    the drain/overlap/epoch serialization below."""

    def __init__(self, owner, *, tick_budget: Optional[int] = None,
                 clock: Optional[Callable[[], int]] = None,
                 starvation_ticks: int = STARVATION_TICKS):
        if tick_budget is not None and int(tick_budget) <= 0:
            raise ConfigError(
                f"maintenance tick_budget must be positive (or None for "
                f"unlimited), got {tick_budget}"
            )
        self.owner = owner
        self.tick_budget = None if tick_budget is None else int(tick_budget)
        self.starvation_ticks = int(starvation_ticks)
        self._tasks: dict[str, _TaskState] = {}
        # The monotonic tick clock (satellite: FQDN TTL expiry and the
        # recompile backoff consult THIS clock, not their own `now`).
        # An external deterministic clock (faults.FaultClock) overrides.
        self._clock = clock
        self._now = 0
        self.ticks_total = 0
        self.blocked_ticks_total = 0  # serialization deferrals
        self.forced_total = 0
        self.overlap_flushed_total = 0
        # Tick-clock instant of the first real (non-blocked) round: the
        # lag reference for tasks never granted yet — before any round,
        # denial has not happened, so lag must read 0 even if observe()
        # already folded a large packet-clock now into the tick clock.
        self._first_tick_at: Optional[int] = None

    # -- clock ---------------------------------------------------------------

    def clock(self) -> int:
        """The scheduler's monotonic tick clock — the one notion of `now`
        every consolidated plane consults."""
        if self._clock is not None:
            self._now = max(self._now, int(self._clock()))
        return self._now

    def observe(self, now) -> None:
        """Fold a packet-clock timestamp into the tick clock.  Engines
        call this from step(): traffic time is what stamps flow-cache
        last_seen and FQDN learn expiries, so a default tick (GET
        /maintenance?tick=1 or `antctl maintenance --tick` with no now=)
        must age and expire in the SAME clock domain — a self-advancing
        tick clock starting at 0 would otherwise sit below the stamps
        forever and never expire anything."""
        n = int(now)
        if n > self._now:
            self._now = n

    def _advance(self, now: Optional[int]) -> int:
        if now is not None:
            self._now = max(self._now, int(now))
        elif self._clock is not None:
            # An injected clock (faults.FaultClock) IS the notion of now:
            # never self-advance past it, or backoff windows and TTL
            # expiries would elapse by counting ticks while the
            # fault-injected time stands still.
            self._now = max(self._now, int(self._clock()))
        else:
            self._now += 1
        return self._now

    # -- registration --------------------------------------------------------

    def register(self, task: MaintenanceTask) -> MaintenanceTask:
        if task.name in self._tasks:
            raise ValueError(f"maintenance task {task.name!r} is already "
                             f"registered")
        if self.tick_budget is not None and task.min_cost > self.tick_budget:
            # A grant can never exceed the global tick budget, so a task
            # whose minimum cost does would be deferred on EVERY tick —
            # deficit banking cannot help (give is clamped to remaining)
            # and the starvation boost only reorders.  Fail loudly at
            # registration instead of starving silently forever.
            raise ConfigError(
                f"maintenance task {task.name!r}: min_cost {task.min_cost} "
                f"exceeds tick_budget {self.tick_budget}; the task could "
                f"never be granted and would starve — raise maint_budget "
                f"or shrink the task (e.g. canary_probes)"
            )
        self._tasks[task.name] = _TaskState(task)
        return task

    def unregister(self, name: str) -> None:
        self._tasks.pop(name, None)

    @property
    def task_names(self) -> list[str]:
        return sorted(self._tasks)

    # -- serialization point -------------------------------------------------

    def _engine(self):
        return getattr(self.owner, "_slowpath", None)

    def _blocked(self) -> Optional[str]:
        """Why this tick must defer entirely, or None.  The ONE
        serialization rule: maintenance never interleaves with an
        in-flight drain (begin_drain..finish_drain) — the popped block is
        pinned to cache state the tasks would mutate under it."""
        sp = self._engine()
        if sp is not None and sp._inflight is not None:
            return "inflight-drain"
        return None

    def _settle_overlap(self) -> int:
        """Retire staged overlapped drain commits before any task touches
        the cache: audit evictions and aging passes must observe settled
        metrics/state, not race a deferred finalizer."""
        sp = self._engine()
        if sp is None or not sp.overlap:
            return 0
        n = sp.flush_commits()
        self.overlap_flushed_total += n
        return n

    def _effective_priority(self, st: _TaskState, degraded: bool,
                            stale: bool) -> tuple:
        t = st.task
        pr = t.priority
        if degraded and t.degraded_priority is not None:
            pr = t.degraded_priority
        if stale and t.name == "cache-maintain":
            # A stale epoch is healed FIRST — ahead even of a starvation
            # boost: audits walking the cache behind an unhealed bundle
            # swap would re-prove rows the fused maintenance pass is
            # about to reclaim.
            return (0, pr, t.name)
        starving = st.starved >= self.starvation_ticks
        # Starving tasks jump the queue (behind only a front-of-queue
        # heal), which is what makes DRR starvation-free under a tight
        # global budget.
        return (1 if starving else 2, pr, t.name)

    # -- the tick ------------------------------------------------------------

    def tick(self, now: Optional[int] = None,
             budget: Optional[int] = None) -> dict:
        """One scheduler round: serialize -> order -> deficit-round-robin.
        `budget` (default: the construction-time tick_budget) caps the
        TOTAL units spent this tick across all tasks; per-task quanta cap
        each task.  Returns {now, ran, deferred, shed, spent, blocked}."""
        if budget is not None and int(budget) <= 0:
            # Same contract as the construction-time tick_budget: a
            # zero/negative per-call budget (GET /maintenance?tick=1&
            # budget=0) would count a real tick that defers every task,
            # distorting starvation counters and scheduler lag.
            raise ConfigError(
                f"maintenance tick budget must be positive, got {budget}")
        t = self._advance(now)
        out: dict = {"now": t, "ran": {}, "deferred": [], "shed": [],
                     "spent": 0, "blocked": None, "overlap_flushed": 0}
        rec = getattr(self.owner, "_flightrec", None)
        blocked = self._blocked()
        if blocked is not None:
            self.blocked_ticks_total += 1
            out["blocked"] = blocked
            for st in self._tasks.values():
                st.deferrals_total += 1
                st.starved += 1
                out["deferred"].append(st.task.name)
            if rec is not None:
                rec.emit(kind="maint-blocked", reason=blocked, at=t)
            return out
        self.ticks_total += 1
        if self._first_tick_at is None:
            self._first_tick_at = t
        out["overlap_flushed"] = self._settle_overlap()
        degraded = bool(getattr(self.owner, "degraded", False))
        sp = self._engine()
        stale = bool(sp is not None and sp.stale)
        remaining = self.tick_budget if budget is None else int(budget)
        order = sorted(self._tasks.values(),
                       key=lambda s: self._effective_priority(
                           s, degraded, stale))
        for st in order:
            task = st.task
            if degraded and task.shed_when_degraded:
                st.shed_total += 1
                st.starved = 0  # shed is a decision, not starvation
                # ...and therefore not lag either: the task had its turn
                # and the scheduler chose to shed it, so the lag gauge
                # must not climb for the whole degraded window.
                st.last_granted_at = t
                out["shed"].append(task.name)
                continue
            st.deficit = min(st.deficit + task.budget,
                             task.budget * DEFICIT_CAP_TICKS)
            give = st.deficit if remaining is None else min(st.deficit,
                                                            remaining)
            if give < task.min_cost:
                # Budget-clamped out of this tick: the deficit carries
                # over, so the task runs once it can afford min_cost.
                st.deferrals_total += 1
                st.starved += 1
                out["deferred"].append(task.name)
                continue
            st.last_granted_at = t
            spent = int(task.run(t, give) or 0)
            if spent > give:
                # A task must never exceed its grant; clamp the
                # accounting and meter the overrun loudly.
                st.overruns_total += 1
                spent = give
            st.deficit -= spent
            if spent > 0:
                st.runs_total += 1
                st.spent_total += spent
                st.last_ran_at = t
                out["ran"][task.name] = spent
                out["spent"] += spent
                if remaining is not None:
                    remaining -= spent
            st.starved = 0  # it got a real grant, whether or not it acted
        if rec is not None:
            rec.emit(kind="maint-tick", at=t, ran=dict(out["ran"]),
                     deferred=list(out["deferred"]),
                     shed=list(out["shed"]), spent=int(out["spent"]))
        return out

    def force(self, fn: Callable[[int], dict],
              now: Optional[int] = None) -> dict:
        """Run one operator-forced maintenance action (e.g. the /audit
        ?force=1 full sweep) behind the SAME serialization point as
        tick() — staged overlap commits retire first, and the action
        shares the tick clock.  An in-flight drain raises: the operator
        path must not corrupt a pinned block either."""
        t = self._advance(now)
        blocked = self._blocked()
        if blocked is not None:
            raise RuntimeError(
                f"maintenance action refused: {blocked} (finish the "
                f"in-flight drain first)")
        self._settle_overlap()
        self.forced_total += 1
        return fn(t)

    # -- observability -------------------------------------------------------

    def scheduler_lag(self) -> int:
        """Tick-clock age of the most-starved task: max over tasks of
        (now - last time it was GRANTED its min cost).  Denied
        opportunity, not healthy idleness — a task that keeps getting
        its grant but has no work (recompile while healthy) reads 0."""
        if self._first_tick_at is None:
            return 0  # no round yet: nothing has been denied
        lag = 0
        # One-shot snapshot: this renders on the agent handler thread
        # (HANDLER_SAFE maintenance_stats) while the engine thread may be
        # registering a late task (reshard-migrate, tenant-maintain,
        # replica-health) — iterating the live dict would race a
        # mid-iteration resize.
        for st in list(self._tasks.values()):
            ref = (st.last_granted_at if st.last_granted_at >= 0
                   else self._first_tick_at)
            lag = max(lag, self._now - ref)
        return lag

    def stats(self) -> dict:
        return {
            "now": int(self._now),
            "tick_budget": self.tick_budget,
            "ticks_total": int(self.ticks_total),
            "blocked_ticks_total": int(self.blocked_ticks_total),
            "forced_total": int(self.forced_total),
            "overlap_flushed_total": int(self.overlap_flushed_total),
            "scheduler_lag": int(self.scheduler_lag()),
            "tasks": {
                name: {
                    "budget": int(st.task.budget),
                    "priority": int(st.task.priority),
                    "min_cost": int(st.task.min_cost),
                    "shed_when_degraded": bool(st.task.shed_when_degraded),
                    "deficit": int(st.deficit),
                    "runs_total": int(st.runs_total),
                    "spent_total": int(st.spent_total),
                    "deferrals_total": int(st.deferrals_total),
                    "shed_total": int(st.shed_total),
                    "overruns_total": int(st.overruns_total),
                    "last_ran_at": int(st.last_ran_at),
                    "last_granted_at": int(st.last_granted_at),
                }
                # list() before sorted(): the handler thread renders this
                # table while the engine thread may register a late task
                # (reshard-migrate / tenant-maintain / replica-health) —
                # snapshot once so the task table can never miss or race
                # a registration mid-iteration.
                for name, st in sorted(list(self._tasks.items()))
            },
        }


class MaintainableDatapath:
    """Mixin exposing the PUBLIC maintenance surface on an engine.

    Engines call `_init_maintenance` at the very END of their
    constructor (after the slow-path engine, commit plane and audit
    plane exist — the default tasks close over all three).  Both twins
    register the same task set with the same budgets, so tick semantics
    mirror task-for-task and parity/audit stay provable mode-for-mode."""

    _maintenance: Optional[MaintenanceScheduler] = None

    def _init_maintenance(self, *, maint_budget: Optional[int] = None,
                          maint_clock=None,
                          maint_age_every: int = 16) -> None:
        if maint_age_every <= 0:
            raise ConfigError(
                f"maint_age_every must be positive, got {maint_age_every}")
        sched = MaintenanceScheduler(self, tick_budget=maint_budget,
                                     clock=maint_clock)
        self._maintenance = sched
        self._maint_age_every = int(maint_age_every)
        self._maint_last_age = -(1 << 30)  # first tick runs an aging pass
        self._maint_backoff = 0
        # Two windows, one shared exponent: `_maint_retry_at` gates the
        # SCHEDULER's recompile task (opened by either caller's failed
        # attempt); `_maint_sched_retry_at` gates sync() via
        # maintenance_recovery_due and is opened only by the scheduler's
        # OWN failed attempt — sync paces its own failures on the agent
        # clock (_retry_at), and a sync-opened tick-clock window must not
        # wedge sync when nothing advances the tick clock in between.
        self._maint_retry_at = 0
        self._maint_sched_retry_at = 0
        cp = self._commit
        au = self._audit
        # Recovery first while degraded; inert (spent 0) when healthy.
        sched.register(MaintenanceTask(
            "degraded-recompile", self._maint_recompile, budget=1,
            priority=6, degraded_priority=0))
        probes = max(1, int(cp.probes))
        sched.register(MaintenanceTask(
            "canary", self._maint_canary, budget=probes, min_cost=probes,
            priority=2, degraded_priority=1))
        sched.register(MaintenanceTask(
            "audit-cursor", self._maint_audit_cursor, budget=au.window,
            priority=3))
        # Cosmetic while degraded: the scrub re-certifies bytes the
        # recompile is about to replace wholesale.  The scrub is
        # all-or-nothing (one digest fold over the whole manifest), so
        # its true cost — one unit per manifest tensor — is the min cost:
        # the scheduler defers it until a grant affords the full fold
        # rather than letting a 1-unit grant buy the whole scrub.
        scrub_cost = len(SCRUB_MANIFEST)
        sched.register(MaintenanceTask(
            "tensor-scrub", self._maint_tensor_scrub,
            budget=max(8, scrub_cost), min_cost=scrub_cost,
            priority=4, shed_when_degraded=True))
        if self._slowpath is not None:
            sched.register(MaintenanceTask(
                "cache-maintain", self._maint_cache, budget=1, priority=1))
        # Observability bookkeeping: the flight recorder and the
        # realization tracer account their recording cost HERE — one
        # budgeted task whose spend is the stamps/events recorded since
        # its last grant — instead of smearing it invisibly across
        # whichever plane happened to emit.  A burst larger than one
        # grant carries over as backlog (not an overrun: emit itself is
        # never deferred, only its accounting is spread).
        self._obs_cost_backlog = 0
        self._obs_rec_taken = 0
        rec = getattr(self, "_flightrec", None)
        if rec is not None:
            # The journal's timebase IS the scheduler's tick clock — one
            # notion of now across ticks, backoffs, TTLs and the journal,
            # fault-injectable via faults.FaultClock.
            rec.set_clock(sched.clock)
        if rec is not None or getattr(self, "_realization", None) is not None:
            sched.register(MaintenanceTask(
                "observability", self._maint_observability, budget=64,
                priority=5))
        # Telemetry sentinel (observability/telemetry.py): budgeted
        # regime sweep comparing rolling-window p99 against the rolling
        # baseline, journaling perf-regression.  Cosmetic while degraded
        # — a degraded engine is ALREADY in recovery; a latency verdict
        # adds nothing the commit plane doesn't know.
        if getattr(self, "_telemetry", None) is not None:
            sched.register(MaintenanceTask(
                "telemetry-sentinel", self._maint_telemetry_sentinel,
                budget=2, priority=7, shed_when_degraded=True))

    # -- public surface ------------------------------------------------------

    @property
    def maintenance(self) -> MaintenanceScheduler:
        return self._maintenance

    def maintenance_tick(self, now: Optional[int] = None,
                         budget: Optional[int] = None) -> dict:
        """One budgeted background-plane round (the ONLY way the five
        consolidated loops run; see MaintenanceScheduler.tick)."""
        return self._maintenance.tick(now, budget)

    def maintenance_stats(self) -> dict:
        """Scheduler counters for the metrics/API planes."""
        return self._maintenance.stats()

    def maintenance_force_audit(self, now: int = 0) -> dict:
        """Operator-forced synchronous full-cache audit sweep, serialized
        by the scheduler (the agent API's /audit?force=1 path)."""
        return self._maintenance.force(
            lambda t: self._audit.scan(t, full=True), now=now)

    def maintenance_recovery_due(self) -> bool:
        """Agent hook (agent/controller.py): is a degraded-mode recompile
        attempt due on the scheduler's tick clock?  The dissemination
        plane's recovery (sync's forced full bundle) and the scheduler's
        degraded-recompile task share ONE backoff state through this, so
        the two callers never double-hammer run_bundle inside a single
        backoff window.  Always True when healthy (nothing to pace)."""
        if not self._commit.degraded:
            return True
        return self._maintenance.clock() >= self._maint_sched_retry_at

    def maintenance_recovery_failed(self) -> None:
        """Agent hook, the other half of maintenance_recovery_due: a
        sync()-driven recovery install failed, so open the scheduler
        task's backoff window — without this the sharing is
        one-directional and the next maintenance tick fires a second full
        compile+canary run_bundle right behind the failed one.  (Only
        `_maint_retry_at`: sync paces its own retries on the agent
        clock.)"""
        self._maint_backoff = min(max(1, self._maint_backoff * 2),
                                  RECOMPILE_BACKOFF_CAP)
        self._maint_retry_at = self._maintenance.clock() + self._maint_backoff

    # -- the consolidated task runners ---------------------------------------

    def _maint_canary(self, now: int, budget: int) -> int:
        """Live-bundle canary watchdog tick.  recover=False: detection
        only — the degraded-recompile task owns recovery pacing, so a
        degraded tick must not double-drive run_bundle off-backoff."""
        cp = self._commit
        if cp.probes <= 0:
            return 0
        scan = cp.canary_scan(now, recover=False)
        # True cost, unclamped: the tick()'s overrun path clamps the
        # accounting AND meters it — a pre-clamp here would hide a probe
        # batch that outgrew its grant.
        return max(int(scan.get("probes", 0)), cp.probes)

    def _maint_audit_cursor(self, now: int, budget: int) -> int:
        out = self._audit.scan(now, rows=budget, scrub=False)
        return int(out["scanned"])

    def _maint_tensor_scrub(self, now: int, budget: int) -> int:
        out = self._audit.scan(now, rows=0, scrub=True)
        # True cost, unclamped — see _maint_canary: one unit per digest
        # folded, PLUS any rows the scan revalidated (a detected
        # corruption escalates to a full-cache sweep inside the same
        # scan; under-reporting it would let a full-table pass hide
        # inside a tiny scrub grant, unmetered).  A digest-only overrun
        # means the scrub manifest grew and the registration is stale.
        return int(out.get("scrubbed", 0)) + int(out.get("scanned", 0))

    def _maint_cache(self, now: int, budget: int) -> int:
        sp = self._slowpath
        if sp is None:
            return 0
        if sp.stale or (now - self._maint_last_age) >= self._maint_age_every:
            sp.maintain(now)
            self._maint_last_age = now
            return 1
        return 0

    def _maint_observability(self, now: int, budget: int) -> int:
        """Recording-cost accounting: spend = flight-recorder events +
        tracer stamp ops since the last grant, spread across ticks when a
        burst exceeds one grant (backlog, not overrun — the emits already
        happened; only their ACCOUNTING waits for budget)."""
        backlog = self._obs_cost_backlog
        rec = getattr(self, "_flightrec", None)
        if rec is not None:
            backlog += rec.seq - self._obs_rec_taken
            self._obs_rec_taken = rec.seq
        tr = getattr(self, "_realization", None)
        if tr is not None:
            backlog += tr.take_cost()
        spent = min(backlog, int(budget))
        self._obs_cost_backlog = backlog - spent
        return spent

    def _maint_telemetry_sentinel(self, now: int, budget: int) -> int:
        """Perf-regression sentinel (observability/telemetry.py): spend =
        regimes judged this grant.  One unit buys one regime's
        window-vs-baseline verdict; the round-robin cursor inside the
        plane guarantees every regime is reached across ticks.  Findings
        are journaled (kind `perf-regression`, clocked by the scheduler
        tick so FaultClock drives reproduction deterministically) and
        metered — NEVER acted on: latency regressions are an operator
        signal, not a correctness fault the commit plane should roll
        back."""
        tp = getattr(self, "_telemetry", None)
        if tp is None:
            return 0
        checked, events = tp.sentinel_sweep(budget)
        for ev in events:
            self._emit("perf-regression", at=now, **ev)
        return checked

    def _maint_recompile(self, now: int, budget: int) -> int:
        """Degraded-mode recovery, paced by a capped exponential backoff
        on the SCHEDULER'S tick clock (previously each caller consulted
        its own notion of now) — run_bundle itself is canary-gated, so a
        passing recompile both recovers and re-certifies."""
        cp = self._commit
        if not cp.degraded:
            self._maint_backoff = 0
            self._maint_retry_at = 0
            self._maint_sched_retry_at = 0
            return 0
        if now < self._maint_retry_at:
            return 0
        try:
            cp.run_bundle(None, None)
            self._maint_backoff = 0
        except Exception:  # noqa: BLE001 — still degraded, still serving
            # LKG verdicts; back off and let a later tick retry.  A
            # scheduler-driven failure opens BOTH windows: sync must not
            # burn a doomed attempt right behind this one either.
            self._maint_backoff = min(max(1, self._maint_backoff * 2),
                                      RECOMPILE_BACKOFF_CAP)
            self._maint_retry_at = now + self._maint_backoff
            self._maint_sched_retry_at = self._maint_retry_at
        return 1
