"""Agent-side NetworkPolicy controller: watch -> ruleCache -> reconcile.

The L3 analog of the reference's agent policy path
(pkg/agent/controller/networkpolicy/networkpolicy_controller.go:910
watcher loop; cache.go:58 ruleCache; pod_reconciler.go:297 Reconcile):
subscribes to the dissemination store for ONE node, assembles the local
span-filtered PolicySet from events alone, and reconciles changes into the
node's Datapath:

  * group membership deltas   -> datapath.apply_group_delta (incremental, no
                                 recompile — the flow-mod analog)
  * policy add/update/delete,
    group add/delete          -> a pending 'rules dirty' flag; sync() folds
                                 everything into ONE install_bundle (the
                                 reference batches via BatchInstallPolicyRule
                                 Flows at bootstrap, network_policy.go:1310)
  * service updates           -> install_bundle(services=...)

The local PolicySet is built ONLY from watch events — never from reaching
into the central controller — which is what makes the dissemination path a
tested boundary.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional

from ..apis import controlplane as cp
from ..compiler.ir import PolicySet
from ..controller.networkpolicy import WatchEvent
from ..datapath.interface import Datapath
from ..dissemination.netwire import Backoff
from ..dissemination.store import RamStore
from ..observability.metrics import Histogram


class AgentPolicyController:
    def __init__(
        self,
        node: str,
        datapath: Datapath,
        store: Optional[RamStore] = None,
        *,
        filestore_dir: Optional[str] = None,
        status_reporter=None,
        retry_backoff_base: float = 0.05,
        retry_backoff_max: float = 5.0,
        clock=time.monotonic,
    ):
        self.node = node
        self.datapath = datapath
        self._ps = PolicySet()
        # uid -> policy in the order of self._ps.policies, and the list it
        # indexes (_policy_index): a policy event costs one dict update
        # and one list copy instead of two Python scans of the list.
        self._pol_index: dict = {}
        self._pol_list: Optional[list] = None
        self._rules_dirty = False
        self._deltas: list[tuple[str, list, list]] = []
        # Datapath install retry (ref: the agent reconciler requeues a
        # failed rule install instead of dropping it): a raising
        # install_bundle keeps the dirty flag set, counts into
        # sync_failures_total, and backs off before the next attempt —
        # the agent never crashes on a flaky datapath.
        self.sync_failures_total = 0
        self.last_sync_error: str = ""
        # Poison-bundle quarantine: a DETERMINISTIC compile rejection
        # (models/pipeline.PolicyCapacityError and kin) fails the same way
        # on every attempt, so retrying it hot just burns the backoff loop
        # forever.  When set, sync() reports the Failed realization
        # upstream and stops retrying until NEW upstream state arrives
        # (any watch event clears it — the next spec may fit).
        self.permanent_failure: str = ""
        # Latency histograms (scraped via render_dissemination_metrics):
        # sync_hist = duration of a sync() that applied state to the
        # datapath; dissemination_hist = controller-commit (WatchEvent.ts)
        # -> datapath-realized latency per event, observed at the first
        # SUCCESSFUL install covering the event — retries extend it, which
        # is the honest realization latency.
        self.sync_hist = Histogram()
        self.dissemination_hist = Histogram()
        # Bounded (latency observations are droppable telemetry; during a
        # persistent install outage events keep arriving and a successful
        # sync may be hours away — the metrics buffer must not undo the
        # plane's bounded-memory guarantee).  The OLDEST stamps are kept:
        # they carry the worst-case latencies the histogram exists to show.
        self._pending_ts: list[float] = []
        self._pending_ts_cap = 4096
        # Meter: stamps truncated at the cap used to
        # vanish silently — understating p99 during exactly the install
        # outages the histogram exists to show.  Scraped as
        # antrea_tpu_realization_stamps_dropped_total.
        self.realization_stamps_dropped_total = 0
        # What the datapath actually enforces: refreshed ONLY on a
        # successful apply, so a failed install can never report upstream
        # as realized (the status plane would mark a generation Realized
        # that no flow table holds).
        self._realized: dict = {}
        # The ONE backoff discipline (netwire.Backoff, shared with the
        # wire reconnect path): capped exponential + jitter.
        self._retry_backoff = Backoff(base=retry_backoff_base,
                                      cap=retry_backoff_max)
        self._retry_at = 0.0
        self._clock = clock
        # Resync window (reconnect re-list): keys re-listed between
        # begin_resync()/end_resync(); anything local but absent from the
        # snapshot is stale and retracted at end_resync.
        self._in_resync = False
        self._resync_seen: set[tuple[str, str]] = set()
        # Realization-status reporting (the agent statusManager analog, ref
        # pkg/agent/controller/networkpolicy status reporting feeding
        # controller status_controller.go:140 UpdateStatus): after every
        # successful datapath apply, report {policy uid: realized spec
        # generation} for this node.  None disables reporting.
        self._status_reporter = status_reporter
        # Filestore fallback (ref pkg/agent/controller/networkpolicy/
        # filestore.go + watcher.FallbackFunc, networkpolicy_controller.go:
        # 923,948): the last-received computed policy state is persisted so
        # a restarted agent can enforce policy while the controller is
        # unreachable.  A live store (re)connect replays everything and
        # overwrites the fallback state.
        self._filestore_dir = filestore_dir
        if filestore_dir is not None and store is None:
            loaded = self._load_filestore()
            if loaded is not None:
                self._ps = loaded
                self._rules_dirty = True
        if store is not None:
            store.watch(node, self.handle_event)

    # -- watcher -------------------------------------------------------------

    def begin_resync(self) -> None:
        """Start of a full re-list from the dissemination plane (server
        resync after reconnect or watcher overflow): events until
        end_resync() constitute the complete span-filtered snapshot."""
        self._in_resync = True
        self._resync_seen = set()

    def end_resync(self) -> None:
        """End of the re-list: retract every local object the snapshot did
        not re-deliver — state that changed while this agent was
        disconnected (the stale-object half of re-list semantics)."""
        if not self._in_resync:
            return
        seen = self._resync_seen
        stale_policies = [p for p in self._ps.policies
                          if ("NetworkPolicy", p.uid) not in seen]
        if stale_policies:
            self._ps.policies = [p for p in self._ps.policies
                                 if ("NetworkPolicy", p.uid) in seen]
            self._rules_dirty = True
        for obj_type, table in (("AppliedToGroup", self._ps.applied_to_groups),
                                ("AddressGroup", self._ps.address_groups)):
            for name in [n for n in table if (obj_type, n) not in seen]:
                del table[name]
                self._rules_dirty = True
        self._in_resync = False
        self._resync_seen = set()

    def handle_event(self, ev: WatchEvent) -> None:
        # New upstream state invalidates a poison-bundle verdict: the next
        # sync() gets exactly one fresh attempt at the changed spec.
        self.permanent_failure = ""
        self._handle_event(ev)
        # Dissemination-latency origin: a stamped event that left pending
        # datapath work starts (or joins) the commit->realized clock,
        # settled by the next successful sync().  Unstamped events
        # (resync replays — reconnect catch-up, not live dissemination)
        # are not measured.
        stamped_pending = bool(ev.ts and (self._rules_dirty or self._deltas))
        if stamped_pending:
            if len(self._pending_ts) < self._pending_ts_cap:
                self._pending_ts.append(ev.ts)
            else:
                # Bounded-memory guarantee kept, loss now METERED: the
                # histogram's p99 understates by exactly this count.
                self.realization_stamps_dropped_total += 1
        # Realization tracing (observability/tracing.py): per-policy
        # spans open at the wire-receipt stamp; unstamped events are
        # excluded and counted, never guessed into the histograms.
        tr = getattr(self.datapath, "realization_tracer", None)
        if (tr is not None and ev.obj_type == "NetworkPolicy"
                and ev.kind != "DELETED" and ev.obj is not None):
            if stamped_pending:
                tr.policy_event(ev.name, getattr(ev.obj, "generation", 0),
                                ev.ts)
            elif not ev.ts:
                tr.note_unstamped()

    def _handle_event(self, ev: WatchEvent) -> None:
        if self._in_resync:
            if ev.kind == "DELETED":
                # A delete interleaved into the re-list window un-lists
                # the object: end_resync must not treat it as re-listed.
                self._resync_seen.discard((ev.obj_type, ev.name))
            else:
                self._resync_seen.add((ev.obj_type, ev.name))
        if ev.obj_type == "NetworkPolicy":
            # The list semantics of the JAX agent (a delete filters the uid
            # out; an upsert filters it out and appends the new object),
            # kept through an index: rebuilding the list with two scans an
            # event is quadratic in the policies (minutes for a world of
            # 25,000 policies).
            pols = self._policy_index()
            if ev.kind == "DELETED":
                pols.pop(ev.name, None)
            else:
                known = ev.name in pols
                if ev.kind == "UPDATED" and ev.span_only and known:
                    return  # dissemination scope changed, spec did not
                obj = copy.deepcopy(ev.obj)
                pols.pop(obj.uid, None)
                pols[obj.uid] = obj
            self._ps.policies = self._pol_list = list(pols.values())
            self._rules_dirty = True
            return

        table = (
            self._ps.applied_to_groups
            if ev.obj_type == "AppliedToGroup"
            else self._ps.address_groups
        )
        if ev.kind == "DELETED":
            if table.pop(ev.name, None) is not None:
                self._rules_dirty = True
            return
        if ev.kind == "ADDED" or ev.name not in table:
            table[ev.name] = copy.deepcopy(ev.obj)
            self._rules_dirty = True
            return
        # UPDATED on a known group: incremental membership delta.
        if ev.added or ev.removed:
            g = table[ev.name]
            removed_ips = [m.ip for m in ev.removed]
            for ip in removed_ips:
                for i, m in enumerate(g.members):
                    if m.ip == ip:
                        del g.members[i]
                        break
            for m in ev.added:
                g.members.append(copy.deepcopy(m))
            self._deltas.append((ev.name, [m.ip for m in ev.added], removed_ips))

    def _policy_index(self) -> dict:
        """uid -> policy, in the order of self._ps.policies; rebuilt when the
        list was replaced or changed elsewhere (the re-list's retraction,
        the filestore load)."""
        if (self._pol_list is not self._ps.policies
                or len(self._pol_index) != len(self._ps.policies)):
            self._pol_index = {p.uid: p for p in self._ps.policies}
            self._pol_list = self._ps.policies
        return self._pol_index

    # -- reconciler ----------------------------------------------------------

    @staticmethod
    def _is_permanent(e: Exception) -> bool:
        """Deterministic compile rejections: the same bundle fails the
        same way every time, so retrying cannot succeed.  The commit
        plane re-raises the impl's exception unwrapped, so isinstance
        classification sees the original type."""
        from ..models.pipeline import PolicyCapacityError

        return isinstance(e, PolicyCapacityError)

    def _emit(self, kind: str, **fields) -> None:
        """Journal an agent-plane transition into the datapath's flight
        recorder (observability/flightrec.py) when it has one."""
        from ..observability.flightrec import emit_into

        emit_into(self.datapath, kind, **fields)

    def _install_failed(self, e: Exception) -> None:
        """Record a failed datapath install: the dirty flag STAYS set (the
        state is still pending, exactly the reference reconciler's requeue)
        and the next attempt waits out a capped exponential backoff — or,
        for a DETERMINISTIC compile rejection, is quarantined entirely
        (permanent_failure) until new upstream state arrives, instead of
        burning the backoff loop forever on a poison bundle."""
        self.sync_failures_total += 1
        self.last_sync_error = str(e)
        self._emit("agent-sync", outcome="error", node=self.node,
                   error=f"{type(e).__name__}: {e}"[:200])
        if self._is_permanent(e):
            self.permanent_failure = f"{type(e).__name__}: {e}"
            self._emit("agent-quarantine", node=self.node,
                       reason=self.permanent_failure[:200])
        else:
            self._retry_at = self._clock() + self._retry_backoff.next_delay()
            # The maintenance scheduler's degraded-recompile task shares
            # this backoff (maintenance_recovery_due); a failed install
            # must open ITS window too, or the next tick double-hammers
            # run_bundle right behind us.
            failed = getattr(self.datapath, "maintenance_recovery_failed",
                             None)
            if failed is not None:
                failed()
        self._report_status(failure=str(e))

    def _observe_synced(self, t0: float) -> None:
        """A sync() successfully applied state: record its duration and
        settle every pending commit->realized latency observation."""
        t = self._clock()
        self.sync_hist.observe(max(t - t0, 0.0))
        for ts in self._pending_ts:
            # Clamped: tests drive _clock with fake counters that are not
            # comparable to the store's monotonic stamps.
            self.dissemination_hist.observe(max(t - ts, 0.0))
        self._pending_ts.clear()
        self._emit("agent-sync", outcome="ok", node=self.node,
                   generation=int(self.datapath.generation))
        # Realization spans: every pending span rode the commit this
        # sync just drove — bind them to its stage stamps; the span
        # closes at the first live packet hit on the new generation.
        tr = getattr(self.datapath, "realization_tracer", None)
        if tr is not None:
            tr.realized()

    def sync(self) -> None:
        """Apply pending changes to the datapath: one bundle for structural
        changes, or the queued incremental deltas otherwise.  The filestore
        fallback is refreshed only after a SUCCESSFUL apply — it records the
        last state actually pushed to the datapath; idle syncs touch no
        disk.

        A raising install does NOT crash the agent: the failure is counted
        (sync_failures_total), reported upstream as a Failed realization,
        and retried with backoff on later sync() calls — the dirty state is
        never dropped."""
        if getattr(self.datapath, "degraded", False):
            # Quarantined datapath (datapath/commit.py): it is serving
            # last-known-good verdicts after a rollback and rejects
            # incremental deltas until a full-bundle recompile passes its
            # canary.  The agent holds the authoritative PolicySet, so
            # force the bundle path — even with nothing locally pending —
            # paced by the existing retry/backoff discipline AND the
            # maintenance scheduler's shared recompile backoff
            # (datapath/maintenance.py maintenance_recovery_due: the
            # degraded-recompile task and this forced bundle must never
            # double-hammer run_bundle inside one backoff window).
            if self._deltas:
                # Deltas cannot apply while quarantined (they raise
                # BundleQuarantinedError immediately); fold them into the
                # full-bundle recovery — the local PolicySet already
                # reflects the membership — instead of burning a doomed
                # attempt that would bypass the shared backoff below.
                self._deltas.clear()
                self._rules_dirty = True
            due = getattr(self.datapath, "maintenance_recovery_due", None)
            if due is not None and not due():
                return  # shared backoff window still open; state pends
            self._rules_dirty = True
        if not self._rules_dirty and not self._deltas:
            return
        if self.permanent_failure:
            # Poison bundle (deterministic compile rejection, e.g.
            # PolicyCapacityError): already reported as a Failed
            # realization; hot-retrying cannot succeed.  Quarantined until
            # a new watch event changes the spec (handle_event clears).
            return
        t0 = self._clock()
        if self._rules_dirty:
            if t0 < self._retry_at:
                return  # backing off a failed install; state stays pending
            # A bundle folds any pending deltas too (membership is already
            # reflected in the local PolicySet).
            try:
                self.datapath.install_bundle(ps=copy.deepcopy(self._ps))
            except Exception as e:
                self._install_failed(e)
                return
            self._retry_backoff.reset()
            self._retry_at = 0.0
            self._rules_dirty = False
            self._deltas.clear()
            self._realized = {p.uid: p.generation for p in self._ps.policies}
            self._save_filestore()
            self._observe_synced(t0)
            self._report_status()
            return
        try:
            for name, added, removed in self._deltas:
                try:
                    self.datapath.apply_group_delta(name, added, removed)
                except KeyError:
                    # Group unknown to the datapath snapshot (e.g. delta
                    # arrived before any bundle): fall back to a bundle.
                    self.datapath.install_bundle(ps=copy.deepcopy(self._ps))
                    break
        except Exception as e:
            # A failed delta/bundle leaves the datapath on its previous
            # consistent snapshot; fold the pending membership into a full
            # bundle retry (the local PolicySet already reflects it).
            self._deltas.clear()
            self._rules_dirty = True
            self._install_failed(e)
            return
        self._deltas.clear()
        self._realized = {p.uid: p.generation for p in self._ps.policies}
        self._save_filestore()
        self._observe_synced(t0)
        self._report_status()

    def realized_generations(self) -> dict:
        """{policy uid: spec generation} this agent has ACTUALLY applied
        to its datapath — the per-node realization the status plane
        aggregates.  Tracks successful installs, not the local PolicySet:
        state received but not yet (or unsuccessfully) installed stays
        unreported, so the aggregate phase shows Realizing until the
        datapath really enforces it."""
        return dict(self._realized)

    def _report_status(self, failure: str = "") -> None:
        if self._status_reporter is None:
            return
        if failure:
            self._status_reporter(
                self.node, self.realized_generations(),
                failure=failure,
            )
        else:
            self._status_reporter(self.node, self.realized_generations())

    @property
    def policy_set(self) -> PolicySet:
        return self._ps

    # -- filestore fallback ----------------------------------------------------

    def _filestore_path(self) -> str:
        return os.path.join(self._filestore_dir, f"agent_policies_{self.node}.json")

    def _save_filestore(self) -> None:
        if self._filestore_dir is None:
            return
        from ..datapath.persist import atomic_write_json
        from ..dissemination import serde

        atomic_write_json(
            self._filestore_path(), serde.encode_policy_set(self._ps)
        )

    def _load_filestore(self) -> Optional[PolicySet]:
        from ..datapath.persist import read_json
        from ..dissemination import serde

        body = read_json(self._filestore_path())
        if body is None:
            return None
        try:
            return serde.decode_policy_set(body)
        except (ValueError, KeyError, TypeError, AttributeError):
            return None
