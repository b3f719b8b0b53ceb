"""Transactional bundle commit plane: compile -> canary -> swap -> settle.

The reference agent's make-before-break cookie-round model (see
datapath/persist.py) guarantees a bad policy push can never take the
datapath from "serving correct verdicts" to "serving nothing".  This module
adds the stronger guarantee this build needs: a bad push can never take the
datapath to "serving WRONG verdicts" either.  Every `install_bundle` /
`apply_group_delta` on either engine runs one transaction:

  compile   the engine builds + swaps in the candidate tensors
            (`_install_bundle_impl` / `_apply_group_delta_impl`); any
            exception here is a rejected candidate;
  canary    a small synthetic probe batch — fresh 5-tuples derived
            deterministically from the bundle's OWN rule set
            (compiler/ir.canary_probe_tuples), so established-flow cache
            semantics can never mask a miscompile — is classified through
            the candidate's fresh-walk path (`_canary_classify`) and every
            verdict is diffed against the scalar Oracle interpreter;
  swap      only a canary-clean candidate is accepted (the engine swap is
            atomic by construction and no traffic steps inside the
            transaction, so gating acceptance here IS gating the swap);
  settle    durability: the two-slot snapshot rotates (persist.py) and the
            candidate becomes the retained last-known-good generation.

On a compile exception or canary mismatch the plane restores the retained
last-known-good state (`_commit_snapshot`/`_commit_restore` — flow-cache
attribution, membership mirrors, device tensors, generation) and enters a
visible DEGRADED mode: the datapath keeps serving LKG verdicts, rejects
incremental deltas with `BundleQuarantinedError` (a delta against a
quarantined bundle would compound the divergence), and recovers only when a
full-bundle recompile passes its canary.  A runtime watchdog
(`canary_scan`, off-hot-step like the slow-path age_scan) re-runs the
canary against the LIVE bundle so silent corruption is detected between
installs, not only at install time.

Observability: `commit_stats()` (scraped as antrea_tpu_bundle_commits_total
{stage,outcome}, antrea_tpu_bundle_rollbacks_total,
antrea_tpu_canary_probes_total / antrea_tpu_canary_mismatches_total,
antrea_tpu_datapath_degraded, antrea_tpu_bundle_lkg_generation /
antrea_tpu_bundle_lkg_age_seconds) and the agent API's /commitplane route.

Fault injection: `arm_commit_faults(plan, name)` wires a dissemination
FaultPlan into the plane; sites f"{name}.compile" and f"{name}.canary" let
the chaos tier force a rollback deterministically (dissemination/faults.py
arms them automatically when FlakyDatapath wraps a transactional datapath).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional

import numpy as np

from ..compiler.ir import canary_probe_tuples
from ..oracle.interpreter import Oracle
from ..packet import Packet, PacketBatch
from ..utils import ip as iputil

STAGE_COMPILE = "compile"
STAGE_CANARY = "canary"
STAGE_SWAP = "swap"
STAGE_SETTLE = "settle"
STAGE_WATCHDOG = "watchdog"


class BundleQuarantinedError(RuntimeError):
    """An incremental delta was rejected because the datapath is degraded
    (serving the last-known-good bundle after a rollback): only a
    full-bundle recompile that passes its canary lifts the quarantine."""


class CanaryMismatchError(RuntimeError):
    """The canary stage found candidate-vs-oracle verdict mismatches: the
    bundle compiles but classifies wrongly.  Carries the mismatch records
    ({src, dst, proto, sport, dport, got, want} dicts, or
    {"injected": ...} for fault-plan-forced failures)."""

    def __init__(self, mismatches: list):
        self.mismatches = list(mismatches)
        first = self.mismatches[0] if self.mismatches else {}
        super().__init__(
            f"canary found {len(self.mismatches)} candidate-vs-oracle "
            f"verdict mismatch(es); first: {first}"
        )


class CommitPlane:
    """Per-datapath commit state machine + LKG retention + degraded mode.

    The owner is duck-typed (either engine); the contract:

      owner._install_bundle_impl(ps, services) -> gen   compile+swap
      owner._apply_group_delta_impl(name, a, r) -> gen  incremental path
      owner._commit_snapshot(group=None) -> snap        retained generation
                                                        (group scopes the
                                                        O(delta) path)
      owner._commit_restore(snap)                       rollback to it
      owner._canary_classify(batch, now) -> codes       fresh-walk verdicts
      owner._persist() / owner._record_round()          settle durability
      owner._ps / owner._services / owner._gen          the spec state
    """

    def __init__(self, owner, *, probes: int = 64, clock=time.monotonic):
        self.owner = owner
        self.probes = int(probes)
        self._clock = clock
        self.degraded = False
        self.last_error = ""
        # (stage, outcome) -> count; outcomes: ok | error | mismatch.
        self.commits: Counter = Counter()
        self.rollbacks_total = 0
        self.canary_probes_total = 0
        self.canary_mismatches_total = 0
        # Replica-resolved mismatches (mesh engines only; see _canary):
        # data-replica id -> mismatch records attributed to it.  Empty
        # forever on single-chip owners.
        self.replica_mismatches: Counter = Counter()
        self.quarantined_total = 0
        # Commit sequence: drives fresh probe src_ports (a canary round
        # must never re-probe a 5-tuple an earlier round used).
        self.seq = 0
        self.lkg_generation = int(owner._gen)
        self.lkg_at = clock()
        self._plan = None
        self._site = ""

    # -- observability (flight recorder + realization tracer) ----------------

    def _tracer(self):
        """The owner's realization tracer (observability/tracing.py) —
        the commit plane stamps the compile/canary/swap/settle stage
        boundaries of every realization span."""
        return getattr(self.owner, "_realization", None)

    def _emit(self, kind: str, **fields) -> None:
        from ..observability.flightrec import emit_into

        emit_into(self.owner, kind, **fields)

    # -- fault injection (dissemination/faults.py sites) ---------------------

    def arm_faults(self, plan, name: str) -> None:
        """Consult `plan` at sites f"{name}.compile" / f"{name}.canary" on
        every commit — the chaos tier's deterministic rollback trigger.
        The plan also journals every firing into the owner's flight
        recorder, so a post-mortem reads cause and effect in one place."""
        self._plan = plan
        self._site = name
        plan.bind_recorder(getattr(self.owner, "_flightrec", None))

    def _fire_compile_fault(self) -> None:
        if self._plan is None:
            return
        rule = self._plan.fire(f"{self._site}.{STAGE_COMPILE}")
        if rule is not None and rule.kind != "delay":
            from ..dissemination.faults import InjectedCompileError

            raise InjectedCompileError(
                f"injected {rule.kind} on {self._site}.{STAGE_COMPILE}")

    def _fire_canary_fault(self) -> Optional[str]:
        """-> a forced-mismatch description, or None.  An injected canary
        fault models a MISCOMPILE (the probe diff disagreeing), so it
        surfaces as a synthetic mismatch, not an exception — the rollback
        path exercised is exactly the real one."""
        if self._plan is None:
            return None
        rule = self._plan.fire(f"{self._site}.{STAGE_CANARY}")
        if rule is not None and rule.kind != "delay":
            return f"injected {rule.kind} on {self._site}.{STAGE_CANARY}"
        return None

    # -- the transaction ------------------------------------------------------

    def run_bundle(self, ps=None, services=None) -> int:
        o = self.owner
        if self.degraded and ps is None:
            # Recovery from quarantine demands a FULL recompile: a
            # services-only (or no-op) bundle re-lowers the held rule set
            # too, so a passing canary re-certifies the whole bundle.
            ps = o._ps
        tr = self._tracer()
        if tr is not None:
            tr.commit_begin()  # queue_wait ends; the compile stage starts
        snap = self._take_snapshot()
        try:
            self._fire_compile_fault()
            gen = o._install_bundle_impl(ps, services)
            self.commits[(STAGE_COMPILE, "ok")] += 1
            if tr is not None:
                tr.commit_stage(STAGE_COMPILE)
        except Exception as e:
            self.commits[(STAGE_COMPILE, "error")] += 1
            self._emit("commit", stage=STAGE_COMPILE, outcome="error",
                       error=f"{type(e).__name__}: {e}"[:200])
            self._rollback(snap, e)
            raise
        self._canary_gate(snap)
        self.commits[(STAGE_SWAP, "ok")] += 1
        if tr is not None:
            tr.commit_stage(STAGE_SWAP)
        self._settle(gen, delta=False)
        return gen

    def run_delta(self, group_name: str, added_ips, removed_ips) -> int:
        o = self.owner
        if self.degraded:
            self.quarantined_total += 1
            raise BundleQuarantinedError(
                f"datapath is degraded (serving last-known-good generation "
                f"{self.lkg_generation}; {self.last_error or 'rolled back'}) "
                f"— incremental deltas are quarantined until a full-bundle "
                f"recompile passes its canary"
            )
        tr = self._tracer()
        if tr is not None:
            tr.commit_begin()
        snap = self._take_snapshot(group=group_name)
        gen0 = int(o._gen)
        try:
            self._fire_compile_fault()
            gen = o._apply_group_delta_impl(group_name, added_ips, removed_ips)
            self.commits[(STAGE_COMPILE, "ok")] += 1
            if tr is not None:
                tr.commit_stage(STAGE_COMPILE)
        except KeyError:
            # Unknown group: the impls validate before mutating anything,
            # and the agent's sync path folds this into a full bundle —
            # not a commit fault, no rollback bookkeeping.
            if tr is not None:
                tr.commit_abort()
            raise
        except Exception as e:
            self.commits[(STAGE_COMPILE, "error")] += 1
            self._emit("commit", stage=STAGE_COMPILE, outcome="error",
                       delta=True, error=f"{type(e).__name__}: {e}"[:200])
            self._rollback(snap, e)
            raise
        if gen == gen0:
            if tr is not None:
                tr.commit_abort()  # no-op: nothing realized by this call
            return gen  # no-op delta: nothing swapped, nothing to certify
        # Delta canary scoped to the touched group's blast radius (plus
        # the delta'd addresses themselves — removals probe as
        # non-members): certification stays in the delta's latency class.
        self._canary_gate(snap, scope={group_name},
                          extra=[*added_ips, *removed_ips])
        self.commits[(STAGE_SWAP, "ok")] += 1
        if tr is not None:
            tr.commit_stage(STAGE_SWAP)
        self._settle(gen, delta=True)
        return gen

    def _canary_gate(self, snap, scope=None, extra=()) -> None:
        """Run the canary against the candidate; mismatch or probe-path
        exception rolls back to `snap` and raises."""
        tr = self._tracer()
        try:
            mism = self._canary(scope=scope, extra=extra)
        except Exception as e:
            self.commits[(STAGE_CANARY, "error")] += 1
            self._emit("commit", stage=STAGE_CANARY, outcome="error",
                       error=f"{type(e).__name__}: {e}"[:200])
            self._rollback(snap, e)
            raise
        if mism:
            self.commits[(STAGE_CANARY, "mismatch")] += 1
            err = CanaryMismatchError(mism)
            self._emit("commit", stage=STAGE_CANARY, outcome="mismatch",
                       mismatches=len(mism))
            self._rollback(snap, err)
            raise err
        self.commits[(STAGE_CANARY, "ok")] += 1
        if tr is not None:
            tr.commit_stage(STAGE_CANARY)

    def _take_snapshot(self, group=None):
        """Engine snapshot + the slow-path engine's epoch-stale flag (the
        rejected impl already called mark_stale; a rollback must not leave
        a spurious full-revalidation pending against the unchanged LKG
        bundle).  `group` scopes a delta snapshot to the touched group."""
        o = self.owner
        sp = getattr(o, "_slowpath", None)
        return (o._commit_snapshot(group=group),
                None if sp is None else sp.stale)

    def _rollback(self, snap, err: Exception) -> None:
        state, stale0 = snap
        tr = self._tracer()
        if tr is not None:
            tr.commit_abort()  # nothing realized; the retry re-stamps
        self.owner._commit_restore(state)
        sp = getattr(self.owner, "_slowpath", None)
        if sp is not None and stale0 is not None:
            sp.stale = stale0
        self.rollbacks_total += 1
        was_degraded = self.degraded
        self.degraded = True
        self.last_error = f"{type(err).__name__}: {err}"
        self._emit("rollback", lkg_generation=int(self.lkg_generation),
                   error=self.last_error[:200])
        if not was_degraded:
            self._emit("degrade", reason=self.last_error[:200])
        self._refresh_audit_golden()

    def _refresh_audit_golden(self) -> None:
        """The tensors just changed legitimately (an accepted candidate or
        a restore to LKG): re-anchor the audit plane's checksum-scrub
        golden digests (datapath/audit.py) so the scrub certifies the NEW
        bytes, not the previous generation's."""
        refresh = getattr(self.owner, "_audit_refresh_golden", None)
        if refresh is not None:
            refresh()

    def _settle(self, gen: int, *, delta: bool) -> None:
        """Durability + LKG retention for an accepted candidate.  The
        incremental path journals the generation only (cookie-round
        append, see the impls' recovery contract); bundles rotate the
        two-slot snapshot.  A persistence failure does NOT roll back or
        degrade — the in-memory bundle passed its canary; only durability
        is pending, and the agent's retry discipline re-drives it."""
        o = self.owner
        try:
            if delta:
                o._persist_dirty = True
                o._record_round()
            else:
                o._persist()
        except Exception as e:
            self.commits[(STAGE_SETTLE, "error")] += 1
            self._emit("commit", stage=STAGE_SETTLE, outcome="error",
                       error=f"{type(e).__name__}: {e}"[:200])
            tr = self._tracer()
            if tr is not None:
                tr.commit_abort()  # durability pending: the agent's
                # retry re-drives the commit, whose stamps then bind
            raise
        self.commits[(STAGE_SETTLE, "ok")] += 1
        was_degraded = self.degraded
        self.degraded = False
        self.last_error = ""
        self.lkg_generation = int(gen)
        self.lkg_at = self._clock()
        tr = self._tracer()
        if tr is not None:
            tr.commit_stage(STAGE_SETTLE)
            tr.commit_done(gen)
        self._emit("commit", stage=STAGE_SETTLE, outcome="ok",
                   gen=int(gen), delta=delta)
        if was_degraded:
            self._emit("recover", gen=int(gen))
        self._refresh_audit_golden()

    # -- canary ---------------------------------------------------------------

    def _frontend_keys(self) -> set:
        """Service frontend addresses of the STAGED service view: probes
        must avoid them (a DNAT'd probe would need the full ServiceLB
        composition the scalar interpreter deliberately does not model —
        the LB path has its own parity suites)."""
        o = self.owner
        fronts: set[int] = set()
        node_ips = list(getattr(o, "_node_ips", ()) or ())
        for s in (getattr(o, "_services", None) or ()):
            ips = [s.cluster_ip, *(s.external_ips or ())]
            if s.node_port:
                ips.extend(node_ips)
            for ip in ips:
                try:
                    fronts.add(iputil.ip_to_key(ip))
                except ValueError:
                    continue
        return fronts

    def _canary(self, scope=None, extra=()) -> list[dict]:
        """Classify this bundle's deterministic probe set through the
        candidate's fresh-walk path and diff against the scalar Oracle ->
        mismatch records (empty = clean).  `scope`/`extra` narrow the
        probe derivation (canary_probe_tuples) for incremental deltas."""
        o = self.owner
        self.seq += 1
        forced = self._fire_canary_fault()
        mism: list[dict] = []
        bad_probes: set[int] = set()
        pkts: list[Packet] = []
        if self.probes > 0:
            fronts = self._frontend_keys()
            pkts = [
                Packet(src_ip=s, dst_ip=d, proto=pr, src_port=sp, dst_port=dp)
                for s, d, pr, sp, dp in canary_probe_tuples(
                    o._ps, seq=self.seq, limit=self.probes,
                    groups=scope, extra_ips=extra)
                if d not in fronts and s not in fronts
            ]
        n_real = len(pkts)
        if pkts:
            # Pad to a FIXED lane count by cycling the real probes: every
            # canary round then shares per-table-shape kernels (eager jax
            # caches compiled kernels per op shape — a scoped delta canary
            # with its own batch size would recompile them all).  Only the
            # real lanes are diffed.
            pkts.extend(pkts[i % n_real] for i in range(self.probes - n_real))
            got = np.asarray(o._canary_classify(
                PacketBatch.from_packets(pkts),
                # Fresh probe clock, disjoint from any plausible packet
                # clock a test or simulator drives (probes never touch
                # state, but the fresh walk still takes a timestamp).
                now=(1 << 20) + self.seq,
            ))
            oracle = Oracle(o._ps)
            self.canary_probes_total += n_real
            # Replica-resolved canaries (the mesh engine) return a
            # (replicas, probes) verdict MATRIX — every data replica
            # classified the same probe set on its own devices.  Each
            # replica row is held to the Oracle independently: ONE
            # replica's divergence is a full veto (the caller's rollback
            # restores the sharded snapshot, i.e. every replica).
            # Single-chip engines return the classic (probes,) vector.
            replicated = got.ndim == 2
            views = got if replicated else got[None, :]
            wants = [int(oracle.classify(p).code) for p in pkts[:n_real]]
            for r in range(views.shape[0]):
                for i, want in enumerate(wants):
                    if int(views[r, i]) == want:
                        continue
                    bad_probes.add(i)
                    p = pkts[i]
                    rec = {
                        "src": iputil.key_to_ip(p.src_ip),
                        "dst": iputil.key_to_ip(p.dst_ip),
                        "proto": p.proto, "sport": p.src_port,
                        "dport": p.dst_port,
                        "got": int(views[r, i]), "want": want,
                    }
                    if replicated:
                        rec["replica"] = r
                    mism.append(rec)
        if forced is not None:
            mism.append({"injected": forced})
        # The legacy counter stays PROBE-deduplicated: a D-replica mesh
        # misclassifying one probe on every replica yields D mismatch
        # RECORDS but one bad probe — counting records would make the
        # same fault read D× the magnitude of a single-chip node on the
        # fleet scrape.  Per-replica volume lives in replica_mismatches.
        self.canary_mismatches_total += len(bad_probes) + (
            1 if forced is not None else 0)
        vetoed = sorted({rec["replica"] for rec in mism if "replica" in rec})
        if vetoed:
            for r in vetoed:
                self.replica_mismatches[r] += sum(
                    1 for rec in mism if rec.get("replica") == r)
            self._emit("replica-canary-veto", replicas=vetoed,
                       mismatches=len(mism))
        if mism:
            self._emit("canary-mismatch", probes=n_real,
                       mismatches=len(mism),
                       first=str(mism[0])[:200])
        return mism

    def canary_scan(self, now: int = 0, recover: bool = True) -> dict:
        """Runtime watchdog (off-hot-step, the age_scan cadence): re-run
        the canary against the LIVE bundle so silent corruption is caught
        between installs.  On mismatch the datapath degrades and a
        full-bundle recompile is attempted immediately (run_bundle's own
        canary certifies it); while degraded, every scan retries the
        recompile.  `recover=False` skips the recompile attempt — the
        maintenance scheduler's degraded-recompile task owns recovery
        pacing (backoff on the tick clock), so its canary ticks must
        detect without double-driving run_bundle.
        -> {probes, mismatches, recovered, degraded}."""
        del now  # probes use the plane's own fresh clock
        before = self.canary_probes_total
        try:
            mism = self._canary()
        except Exception as e:  # noqa: BLE001 — the watchdog exists for
            # exactly this: corruption bad enough to make the probe path
            # RAISE must degrade and drive recovery, never kill the scan
            # loop that detects it.
            mism = [{"error": f"{type(e).__name__}: {e}"}]
            self.canary_mismatches_total += 1
        self.commits[(STAGE_WATCHDOG, "mismatch" if mism else "ok")] += 1
        if mism:
            if not self.degraded:
                self._emit("degrade",
                           reason=f"live canary mismatch: {mism[0]}"[:200])
            self.degraded = True
            self.last_error = f"live canary mismatch: {mism[0]}"
        out = {
            "probes": self.canary_probes_total - before,
            "mismatches": len(mism),
            "recovered": False,
        }
        if self.degraded and recover:
            try:
                self.run_bundle(None, None)
                out["recovered"] = True
            except Exception:
                pass  # still quarantined, still serving LKG verdicts
        out["degraded"] = self.degraded
        return out

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        return {
            "degraded": int(self.degraded),
            "generation": int(self.owner._gen),
            "lkg_generation": int(self.lkg_generation),
            "lkg_age_s": max(0.0, float(self._clock() - self.lkg_at)),
            "commits": {
                f"{stage}/{outcome}": int(n)
                for (stage, outcome), n in sorted(self.commits.items())
            },
            "rollbacks_total": int(self.rollbacks_total),
            "canary_probes_total": int(self.canary_probes_total),
            "canary_mismatches_total": int(self.canary_mismatches_total),
            # Mesh engines only; {} forever on single-chip owners.
            "replica_mismatches": {
                int(r): int(n)
                for r, n in sorted(self.replica_mismatches.items())},
            "quarantined_deltas_total": int(self.quarantined_total),
            "last_error": self.last_error,
        }


class TransactionalDatapath:
    """Mixin routing the PUBLIC install surface through the commit plane.

    Engines implement the private hooks (see CommitPlane's contract) and
    call `_init_commit_plane` at the END of their constructor (after
    persistence restore, so the boot state is the LKG baseline).  The
    public `install_bundle`/`apply_group_delta` live ONLY here —
    analysis pass `commit-plane` fails the build if an engine grows a
    direct tensor-swap entry point outside this plane.
    """

    _commit: Optional[CommitPlane] = None

    def _init_commit_plane(self, *, canary_probes: int = 64,
                           commit_clock=time.monotonic) -> None:
        self._commit = CommitPlane(self, probes=canary_probes,
                                   clock=commit_clock)

    @property
    def commit_plane(self) -> CommitPlane:
        return self._commit

    @property
    def degraded(self) -> bool:
        """Serving last-known-good verdicts after a rollback; deltas are
        quarantined until a full-bundle recompile passes its canary."""
        return bool(self._commit is not None and self._commit.degraded)

    def install_bundle(self, ps=None, services=None) -> int:
        return self._commit.run_bundle(ps, services)

    def apply_group_delta(self, group_name, added_ips, removed_ips) -> int:
        return self._commit.run_delta(group_name, added_ips, removed_ips)

    def canary_scan(self, now: int = 0, recover: bool = True) -> dict:
        """Off-hot-step live-bundle canary watchdog (CommitPlane.canary_scan)."""
        return self._commit.canary_scan(now, recover=recover)

    def commit_stats(self) -> dict:
        """Commit-plane counters for the metrics/API planes."""
        return self._commit.stats()

    def arm_commit_faults(self, plan, name: str) -> None:
        """Wire a FaultPlan into the compile/canary stages (chaos tier)."""
        self._commit.arm_faults(plan, name)
