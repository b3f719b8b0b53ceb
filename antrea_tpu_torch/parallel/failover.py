"""Replica-loss failover: detect, quarantine, ring-evacuate, readmit (the
port of antrea_tpu/parallel/failover.py, on the in-process mesh).

A lost or wedged data replica (a corrupt copy of its tables the audit
cannot heal, a dispatch that stops returning) would otherwise take the
whole mesh down.  This plane is the memberlist discipline on the mesh:

  health detection      the `replica-health` maintenance task (budgeted,
                        NOT shed when degraded — a degraded mesh is
                        exactly when replica loss must still be seen)
                        probes every replica each granted tick with a
                        tiny replica-resolved canary dispatch
                        (`_canary_classify`: each replica walks the probes
                        on its own table copies) and holds each replica's
                        row to the scalar Oracle; the traffic path adds
                        a dispatch-liveness deadline (a mesh step
                        stalling past `dispatch_deadline_s` forces a
                        probe round out of band).  `probe_fails`
                        CONSECUTIVE failed probes -> quarantine.  Death
                        is deterministic in tests via the FaultPlan
                        sites f"{name}.replica_dead" (the probe row
                        reads as diverged) and f"{name}.replica_wedge"
                        (the rule's delay_s rides the probe's measured
                        latency past the deadline) — the rule KIND names
                        the target replica ("r1"; anything else targets
                        replica 0).
  quarantine + ring     a quarantined replica is masked out of serving
  evacuation            IMMEDIATELY: lanes whose current-topology home
                        is the dead replica re-home host-side onto the
                        next-generation consistent ring over the
                        SURVIVORS (the flow-cache slot hash does not
                        depend on D, so rows the survivors commit during
                        masking stay valid across the flip), and the
                        dead replica's queued misses requeue VERBATIM to
                        the survivor queues (MeshSlowPath.
                        evacuate_replica).  The emergency evacuation
                        itself is a ReshardPlane shrink to the survivor
                        device ids with NO source migration from the
                        dead replica (skip_replica): its established
                        flows re-miss at their new ring home and
                        re-classify to the identical verdict, while
                        survivor rows migrate normally.  The cutover is
                        STILL certified: the replica-resolved canary
                        runs on the survivor topology and a corrupted
                        survivor vetoes the flip — the old mesh keeps
                        serving (dead lanes masked), quarantine stays
                        pending, and the evacuation retries after
                        `retry_ticks`.
  certified readmission a healed replica (its probes pass
                        `readmit_passes` consecutive rounds before the
                        evacuation flips, or its fault site stays quiet
                        that long after — or the operator calls
                        `failover_readmit`) rejoins via an ORDINARY
                        certified grow-resize over the boot device ids:
                        migration + canary + audit gate the flip, never
                        a blind re-add.  A pre-flip heal simply unmasks
                        (the old topology never flipped; survivor-side
                        copies of masked flows go stale and idle-expire,
                        verdict-safe by the same re-miss argument).

Devices are the mesh's logical ids (parallel/mesh.mesh_devices): the
survivor list and the boot grid carry them as the JAX plane carries
devices.

Tenant worlds compose: the evacuation shrink is a tenant-aware
ReshardPlane, so every world's rows migrate off the dead replica under
`_world_ctx` and each world certifies its own survivor canary.  A single
world's veto latches ONLY that world (its `_fo_mask` field pins the dead
old-topology index + survivor ring so its lanes keep masking on its own
generation) while certified worlds and the default world flip; the
latched world readmits via `tenant_reshard_resync` or the next resize.
`tenants_pending_evacuation` in failover_stats() names the worlds still
latched or awaiting the evacuation flip.

Documented residue: a SECOND quarantine while a world is still latched
from an earlier veto masks only fleet-aligned worlds; the latched world's
dead-replica lanes re-miss at dispatch instead (verdict-safe, just a
colder path).

Observability: flight-recorder kinds replica-probe-fail /
replica-quarantine / replica-evacuate / replica-readmit, the failover
metric families (observability/metrics.py) and failover_stats().
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..compiler.ir import canary_probe_tuples
from ..observability.flightrec import emit_into
from ..oracle.interpreter import Oracle
from ..packet import Packet, PacketBatch
from .mesh import mesh_devices, shard_of_tuples
from .reshard import ReshardPlane

# Bounded probe history: the last PROBE_RING probe-round records (the
# debug window; BUFFER_CAPS declares the bound).
PROBE_RING = 64

#: "Class.attr" -> what bounds it (the bounded-buffer pass's contract,
#: extended beyond dissemination/ to this plane: probe history between
#: an unbounded producer — every maintenance tick forever — and a
#: consumer that may never read it is the same liability class).
BUFFER_CAPS = {
    "FailoverPlane.probe_ring": "fixed-window list: every append is "
                                "followed by a del-from-front trim to "
                                "PROBE_RING rounds",
}


class FailoverPlane:
    """One mesh's replica-loss failover state machine (the owner is a
    `MeshDatapath`).  Single-threaded like every plane it composes with:
    probes, quarantine, evacuation and readmission all run inside the
    maintenance scheduler's tick; the only traffic-path touches are the
    host-side shard mask and the dispatch-liveness stamp.

    Phases: healthy -> quarantined (mask active, evacuation in flight or
    retrying) -> evacuated (mesh serves D-1, awaiting readmission) ->
    readmitting (certified grow-resize in flight) -> healthy."""

    def __init__(self, owner, *, probe_fails: int = 3,
                 probe_count: int = 8, probe_deadline_s: float = 1.0,
                 dispatch_deadline_s: float = 5.0,
                 readmit_passes: int = 3, retry_ticks: int = 8,
                 auto_readmit: bool = True):
        if probe_fails <= 0:
            raise ValueError(
                f"probe_fails must be positive, got {probe_fails}")
        self.owner = owner
        self.probe_fails = int(probe_fails)
        self.probe_count = int(probe_count)
        self.probe_deadline_s = float(probe_deadline_s)
        self.dispatch_deadline_s = float(dispatch_deadline_s)
        self.readmit_passes = int(readmit_passes)
        self.retry_ticks = int(retry_ticks)
        self.auto_readmit = bool(auto_readmit)
        self.phase = "healthy"
        # Old-topology index of the masked replica (None once the
        # evacuation flips — the new ring has no such index) and its
        # BOOT-GRID identity (stable across the shrink/grow pair; what
        # the quarantined gauge and the fault sites name).
        self.quarantined: Optional[int] = None
        self.quarantined_origin: Optional[int] = None
        self._mask_active = False
        self._mask_n = 0
        self._mask_gen = 0
        self._fail_streak: dict[int, int] = {}
        self._ok_streak: dict[int, int] = {}
        self._quiet_rounds = 0  # post-evacuation heal evidence
        self.probe_ring: list[dict] = []
        self.probes_total = 0
        self.probe_failures_total = 0
        self.slow_dispatches_total = 0
        self.quarantines_total = 0
        self.evacuations_total = 0
        self.readmissions_total = 0
        self.remiss_total = 0
        self.requeued_total = 0
        self._evac_plane = None
        self._readmit_plane = None
        self._readmit_mode = ""
        self._retry_at = 0
        self._probe_asap = False
        self._seq = 0
        self._last_now = 0
        self._probe_cache = None  # (bundle gen, pkts batch, wants)
        # The boot device grid (logical ids): readmission grows back over
        # exactly these devices, so the healed replica returns to its
        # original index.
        self._orig_n = int(owner._n_data)
        self._orig_devices = [int(d) for d in
                              mesh_devices(owner._mesh).reshape(-1)]
        self._plan = None
        self._dead_site = ""
        self._wedge_site = ""

    # -- plumbing ------------------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        emit_into(self.owner, kind, **fields)

    def arm(self, plan, name: str) -> None:
        """Arm the deterministic death/wedge sites from a FaultPlan
        (FlakyDatapath's arm_failover_faults hook): the probe round
        consults f"{name}.replica_dead" and f"{name}.replica_wedge"
        once each; a firing rule's KIND names the target replica."""
        self._plan = plan
        self._dead_site = f"{name}.replica_dead"
        self._wedge_site = f"{name}.replica_wedge"
        plan.bind_recorder(getattr(self.owner, "_flightrec", None))

    @staticmethod
    def _target(kind: str) -> int:
        if kind.startswith("r") and kind[1:].isdigit():
            return int(kind[1:])
        return 0

    def _fire_faults(self):
        dead = wedge = None
        delay = 0.0
        if self._plan is not None:
            rule = self._plan.fire(self._dead_site)
            if rule is not None:
                dead = self._target(rule.kind)
            rule = self._plan.fire(self._wedge_site)
            if rule is not None:
                wedge = self._target(rule.kind)
                delay = float(rule.delay_s)
        return dead, wedge, delay

    # -- traffic-path hooks (host-side only: the step is untouched) ---------

    def note_dispatch(self, elapsed_s: float, now: int) -> None:
        """Dispatch-liveness deadline: a mesh step stalling past the
        deadline is a wedge symptom — force a probe round out of band
        (the probes attribute the stall to a replica)."""
        self._last_now = int(now)
        if elapsed_s > self.dispatch_deadline_s:
            self.slow_dispatches_total += 1
            self._probe_asap = True

    def mask_shard(self, src, dst, proto, sport, dport, shard,
                   tenant: int = 0):
        """Re-home lanes whose current-topology home is the quarantined
        replica onto the survivor ring (next generation, old indexing)
        -> (shard, masked lane mask | None).  The slot hash is
        D-independent, so survivor-side commits stay valid across the
        evacuation flip."""
        # A world latched by a per-tenant evacuation veto carries its
        # OWN mask (dead old-topology index + survivor ring) in its
        # `_fo_mask` world field — inside `_world_ctx` the owner
        # attribute reads the world's latch, and its generation
        # arithmetic is the world's, not the fleet's.
        wm = getattr(self.owner, "_fo_mask", None)
        if wm is not None:
            wd, wn, wg = int(wm[0]), int(wm[1]), int(wm[2])
            wmask = np.asarray(shard) == wd
            if not wmask.any():
                return shard, None
            tgt = shard_of_tuples(
                np.asarray(src)[wmask], np.asarray(dst)[wmask],
                np.asarray(proto)[wmask], np.asarray(sport)[wmask],
                np.asarray(dport)[wmask], wn, wg, tenant=tenant)
            shard = np.array(shard, copy=True)
            shard[wmask] = np.where(tgt >= wd, tgt + 1,
                                    tgt).astype(shard.dtype)
            return shard, wmask
        d = self.quarantined
        if d is None or not self._mask_active:
            return shard, None
        if self._mask_gen != int(self.owner._topo_gen) + 1:
            # Latched world (its _topo_gen is pinned behind the fleet):
            # the fleet mask's survivor arithmetic is meaningless in its
            # indexing — let its dead-replica lanes re-miss at dispatch
            # (documented residue, verdict-safe).
            return shard, None
        m = np.asarray(shard) == d
        if not m.any():
            return shard, None
        tgt = shard_of_tuples(
            np.asarray(src)[m], np.asarray(dst)[m],
            np.asarray(proto)[m], np.asarray(sport)[m],
            np.asarray(dport)[m], self._mask_n, self._mask_gen,
            tenant=tenant)
        shard = np.array(shard, copy=True)
        # Survivor ring index -> old-topology index (skip the dead row).
        shard[m] = np.where(tgt >= d, tgt + 1, tgt).astype(shard.dtype)
        return shard, m

    def _survivor_homes(self, block: dict) -> np.ndarray:
        """Old-topology survivor homes for a popped miss-queue block
        (the quarantine-time verbatim requeue; tenant-aware — queue rows
        carry their world id and the ring hash folds it in)."""
        d = self.quarantined
        cols = (np.asarray(block["src_ip"]).astype(np.uint32),
                np.asarray(block["dst_ip"]).astype(np.uint32),
                np.asarray(block["proto"]).astype(np.int32),
                np.asarray(block["src_port"]).astype(np.int32),
                np.asarray(block["dst_port"]).astype(np.int32))
        ten = np.asarray(block.get("tenant",
                                   np.zeros(cols[0].shape, np.int32)))
        out = np.zeros(cols[0].shape, np.int32)
        for t in np.unique(ten):
            m = ten == t
            out[m] = shard_of_tuples(*(c[m] for c in cols), self._mask_n,
                                     self._mask_gen, tenant=int(t))
        return np.where(out >= d, out + 1, out).astype(np.int32)

    def note_remiss(self, n: int) -> None:
        """Masked lanes that missed on their survivor home — the bounded
        re-miss burst of an evacuation (each dead-resident flow pays
        exactly one re-miss per topology it re-establishes on)."""
        self.remiss_total += int(n)

    # -- the maintenance-task entry point ------------------------------------

    def advance(self, now: int, budget: int) -> int:
        """One granted `replica-health` round -> units spent (probes).
        Probes every replica, drives quarantine, evacuation begin/retry
        and auto-readmission.  The probe round reports its TRUE cost
        unclamped (the canary/scrub discipline)."""
        del budget  # one probe round per grant; cost reported honestly
        self._last_now = int(now)
        spent = self._probe_round(int(now))
        o = self.owner
        if (self.quarantined is not None and self._mask_active
                and self._evac_plane is None and o._reshard is None
                and int(now) >= self._retry_at):
            self._begin_evacuation(int(now))
        elif (self.phase == "evacuated" and self.auto_readmit
              and self._quiet_rounds >= self.readmit_passes
              and self._readmit_plane is None and o._reshard is None):
            self._begin_readmission(int(now), mode="auto")
        return max(spent, 1)

    # -- health detection ----------------------------------------------------

    def _probe_set(self):
        """(pkts batch, oracle wants) for the current bundle — cached per
        bundle generation; padded to a fixed lane count like the commit
        canary so probe rounds share per-shape kernels.  (None, []) when
        the policy set derives no probes."""
        o = self.owner
        gen = int(o._gen)
        if self._probe_cache is not None and self._probe_cache[0] == gen:
            return self._probe_cache[1], self._probe_cache[2]
        # Same frontend exclusion as the commit canary: a probe whose
        # tuple touches a service frontend would need the full ServiceLB
        # composition the scalar Oracle deliberately does not model —
        # keeping it would read as a mismatch on EVERY replica and
        # quarantine a healthy mesh.
        fronts = o._commit._frontend_keys()
        pkts = [
            Packet(src_ip=s, dst_ip=d, proto=pr, src_port=sp, dst_port=dp)
            for s, d, pr, sp, dp in canary_probe_tuples(
                o._ps, seq=1, limit=self.probe_count)
            if d not in fronts and s not in fronts
        ]
        n_real = len(pkts)
        if not pkts:
            self._probe_cache = (gen, None, [])
            return None, []
        oracle = Oracle(o._ps)
        wants = [int(oracle.classify(p).code) for p in pkts]
        pkts.extend(pkts[i % n_real]
                    for i in range(self.probe_count - n_real))
        wants.extend(wants[i % n_real]
                     for i in range(self.probe_count - n_real))
        batch = PacketBatch.from_packets(pkts)
        self._probe_cache = (gen, batch, wants)
        return batch, wants

    def _probe_round(self, now: int) -> int:
        o = self.owner
        D = int(o._n_data)
        self._seq += 1
        self._probe_asap = False
        dead_t, wedge_t, wedge_delay = self._fire_faults()
        batch, wants = self._probe_set()
        elapsed = 0.0
        got = None
        if batch is not None:
            t0 = time.perf_counter()
            got = np.asarray(o._canary_classify(
                batch, now=(1 << 21) + self._seq))
            elapsed = time.perf_counter() - t0
        if self.phase == "evacuated":
            # The dead replica is out of the mesh and unreachable by a
            # probe dispatch; heal evidence is its fault site staying
            # quiet — the CERTIFIED gate is the readmission resize's
            # own canary on the re-grown topology.
            if dead_t is not None and dead_t == self.quarantined_origin:
                self._quiet_rounds = 0
            else:
                self._quiet_rounds += 1
        fails = []
        for r in range(D):
            reason = None
            if dead_t is not None and r == dead_t:
                reason = "fault-dead"
            elif got is not None and any(
                    int(got[r, i]) != w for i, w in enumerate(wants)):
                reason = "mismatch"
            el = elapsed + (wedge_delay if wedge_t == r else 0.0)
            if reason is None and el > self.probe_deadline_s:
                reason = "deadline"
            self.probes_total += 1
            if reason is None:
                self._fail_streak.pop(r, None)
                self._ok_streak[r] = self._ok_streak.get(r, 0) + 1
                continue
            self.probe_failures_total += 1
            self._ok_streak.pop(r, None)
            streak = self._fail_streak.get(r, 0) + 1
            self._fail_streak[r] = streak
            fails.append((r, reason, streak))
            self._emit("replica-probe-fail", replica=int(r),
                       reason=reason, streak=int(streak), at=int(now))
        self.probe_ring.append({
            "round": self._seq, "at": int(now), "n_data": D,
            "failed": [(int(r), reason) for r, reason, _ in fails],
        })
        del self.probe_ring[:-PROBE_RING]
        for r, reason, streak in fails:
            if (streak >= self.probe_fails and self.quarantined is None
                    and self.phase == "healthy" and D >= 2):
                self._quarantine(r, now, reason)
                break  # one quarantine at a time
        if (self.quarantined is not None and self._mask_active
                and self.auto_readmit
                and self._ok_streak.get(self.quarantined, 0)
                >= self.readmit_passes):
            # Probe false-positive: the replica healed BEFORE the
            # evacuation flipped — unmask, no resize needed.
            self._readmit_unmask(now, mode="auto")
        return D * max(len(wants), 1)

    # -- quarantine + ring evacuation ----------------------------------------

    def _quarantine(self, r: int, now: int, reason: str) -> None:
        o = self.owner
        self.quarantined = int(r)
        self.quarantined_origin = int(r)
        self.quarantines_total += 1
        self.phase = "quarantined"
        self._mask_n = int(o._n_data) - 1
        self._mask_gen = int(o._topo_gen) + 1
        self._mask_active = True
        # Journal the DECISION before its consequences (the preempting
        # abort, the requeue, the evacuation begin) so the event stream
        # alone reconstructs cause -> effect.
        self._emit("replica-quarantine", replica=int(r), reason=reason,
                   fail_streak=int(self._fail_streak.get(r, 0)),
                   n_survivors=int(self._mask_n), at=int(now))
        # Per-world context rows: the masked regime is per-tenant
        # observable (which worlds are serving masked, how much queued
        # work each carries toward the evacuation).
        reg = getattr(o, "_tenants", None)
        if reg is not None:
            for tid in sorted(reg.worlds):
                w = reg.worlds[tid]
                self._emit("replica-quarantine", replica=int(r),
                           reason=reason, tenant=int(tid),
                           queued=int(getattr(w, "queued", 0)),
                           n_survivors=int(self._mask_n), at=int(now))
        if o._reshard is not None:
            # Emergency preempts: the in-flight ordinary resize may
            # target (or migrate from) the dead replica.
            o._reshard.abort(
                f"replica {r} quarantine preempts the in-flight resize")
        sp = o._slowpath
        if sp is not None and hasattr(sp, "evacuate_replica"):
            rq, _dropped = sp.evacuate_replica(
                int(r), self._survivor_homes, int(now))
            self.requeued_total += rq
        self._retry_at = int(now)
        self._begin_evacuation(int(now))

    def _survivor_devices(self) -> list:
        o = self.owner
        ids = mesh_devices(o._mesh)
        return [int(d) for rr in range(o._n_data) if rr != self.quarantined
                for d in ids[rr]]

    def _begin_evacuation(self, now: int) -> None:
        # Tenant worlds ride the same shrink: ReshardPlane walks every
        # world's rows under `_world_ctx` and certifies each world's own
        # survivor canary — no tenanted-mesh refusal remains.
        o = self.owner
        plane = ReshardPlane(o, self._mask_n,
                             devices=self._survivor_devices(),
                             skip_replica=self.quarantined)
        o._install_reshard_plane(plane)
        self._evac_plane = plane
        self.phase = "evacuating"

    def note_reshard_finished(self, plane) -> None:
        """Owner lifecycle callback (_finish_reshard): fold an
        evacuation or readmission plane's outcome into the state
        machine.  Ordinary resizes pass through untouched."""
        now = self._last_now
        if plane is self._evac_plane:
            self._evac_plane = None
            if plane.done:
                origin = self.quarantined_origin
                # The survivor topology serves: no old index remains to
                # mask — shard_of_tuples at the flipped generation never
                # elects the dead replica.
                self._mask_active = False
                self.quarantined = None
                self.phase = "evacuated"
                self.evacuations_total += 1
                self._quiet_rounds = 0
                self._fail_streak.clear()
                self._ok_streak.clear()
                self._emit("replica-evacuate", replica=int(origin),
                           n_data=int(self.owner._n_data),
                           migrated_rows=int(plane.migrated_rows),
                           tenant_rows=int(plane.tenant_rows()),
                           tenants_pending=len(self._tenants_pending()),
                           requeued=int(self.requeued_total),
                           remiss=int(self.remiss_total), at=int(now))
            else:
                # Survivor canary veto / audit divergence / flip
                # failure: the OLD mesh keeps serving with the dead
                # replica masked; retry after backoff (a rebuilt plane
                # re-places fresh target rules).
                self.phase = "quarantined"
                self._retry_at = int(now) + self.retry_ticks
        elif plane is self._readmit_plane:
            self._readmit_plane = None
            if plane.done:
                origin = self.quarantined_origin
                self.phase = "healthy"
                self.readmissions_total += 1
                self.quarantined_origin = None
                self._fail_streak.clear()
                self._ok_streak.clear()
                self._emit("replica-readmit", replica=int(origin),
                           mode=self._readmit_mode, gate="resize",
                           n_data=int(self.owner._n_data), at=int(now))
            else:
                # The grow-resize vetoed (the replica is NOT healed —
                # exactly what the certified gate is for): stay
                # evacuated; heal evidence restarts.
                self.phase = "evacuated"
                self._quiet_rounds = 0

    # -- certified readmission -----------------------------------------------

    def readmit(self, mode: str = "operator") -> dict:
        """Re-admission entry point (auto heal detection or the operator
        surface, MeshDatapath.failover_readmit) -> the plane's status
        dict."""
        now = self._last_now
        if self.phase in ("quarantined", "evacuating"):
            self._readmit_unmask(now, mode=mode)
        elif self.phase == "evacuated":
            self._begin_readmission(now, mode=mode)
        elif self.phase == "readmitting":
            pass  # already in flight; idempotent operator surface
        else:
            raise RuntimeError("no quarantined replica to readmit")
        return self.status()

    def _readmit_unmask(self, now: int, mode: str) -> None:
        """Pre-flip heal: the evacuation never cut over, so readmission
        is just dropping the mask — lanes route home again, re-miss
        there once, and the survivor-side copies go stale and
        idle-expire (verdict-safe re-miss both ways)."""
        origin = self.quarantined_origin
        if self._evac_plane is not None:
            self._evac_plane.abort(
                f"replica {origin} healed before the evacuation cutover")
            self._evac_plane = None
        self._mask_active = False
        self.quarantined = None
        self.quarantined_origin = None
        self.phase = "healthy"
        self.readmissions_total += 1
        self._fail_streak.clear()
        self._ok_streak.clear()
        self._emit("replica-readmit", replica=int(origin), mode=mode,
                   gate="unmask", n_data=int(self.owner._n_data),
                   at=int(now))

    def _begin_readmission(self, now: int, mode: str) -> None:
        """The ORDINARY certified grow-resize back over the boot device
        grid: migration + replica-resolved canary + migrated-row audit
        gate the flip — a still-sick replica vetoes and the mesh keeps
        serving the survivor topology."""
        o = self.owner
        try:
            o.reshard_begin(self._orig_n, devices=list(self._orig_devices))
        except Exception:
            if mode != "auto":
                raise
            # Degraded / plane-exclusion refusal: retry on later rounds.
            self._quiet_rounds = 0
            return
        self._readmit_plane = o._reshard
        self._readmit_mode = mode
        self.phase = "readmitting"

    # -- observability -------------------------------------------------------

    def _tenants_pending(self) -> list:
        """World ids still awaiting a certified evacuation: every live
        world while the fleet mask is active (the shrink has not
        flipped), plus any world latched by its own evacuation veto
        (`_fo_mask` pinned) after the fleet flipped around it."""
        reg = getattr(self.owner, "_tenants", None)
        if reg is None:
            return []
        pending = set()
        if self.quarantined is not None and self._mask_active:
            pending.update(int(t) for t in reg.worlds)
        for tid, w in reg.worlds.items():
            if w.fields.get("_fo_mask") is not None:
                pending.add(int(tid))
        return sorted(pending)

    def status(self) -> dict:
        return {
            "phase": self.phase,
            "tenants_pending_evacuation": self._tenants_pending(),
            "quarantined_shard": self.quarantined_origin,
            "mask_active": int(self._mask_active),
            "probes_total": int(self.probes_total),
            "probe_failures_total": int(self.probe_failures_total),
            "slow_dispatches_total": int(self.slow_dispatches_total),
            "quarantines_total": int(self.quarantines_total),
            "evacuations_total": int(self.evacuations_total),
            "readmissions_total": int(self.readmissions_total),
            "remiss_total": int(self.remiss_total),
            "requeued_total": int(self.requeued_total),
            "fail_streaks": {int(r): int(n)
                             for r, n in sorted(self._fail_streak.items())},
            "probe_rounds": int(self._seq),
            "probe_history": [dict(rec) for rec in self.probe_ring[-8:]],
        }
