"""Elastic mesh resharding: resize the data axis under live traffic (the
port of antrea_tpu/parallel/reshard.py, on the in-process mesh).

A `MeshDatapath` serves a (data x rule) mesh whose data axis D was fixed at
construction; this plane resizes it live (grow 2 -> 4, shrink 4 -> 2) with
no established flow lost:

  dual-topology serving   `ReshardPlane` builds the TARGET mesh (a
                          LocalMesh over the target's logical device ids,
                          parallel/mesh.local_mesh) and the next
                          affinity-hash generation (shard_of_tuples'
                          `topo_gen`: the consistent ring).  Batches keep
                          resolving against the OLD topology for the whole
                          resize; the new ring only routes migration.
  drain-and-migrate       a budgeted maintenance task (`reshard-migrate`,
                          rows a tick) walks the per-replica flow-cache
                          tables striped over the global slot space,
                          decodes live rows and re-commits each to its
                          target-ring home at the SAME local slot (the
                          cache slot hash does not depend on D), so
                          committed, reply and attribution state carries
                          bit for bit.  Direct-mapped collisions on a
                          shrink keep the newest row; the loser re-misses
                          and re-classifies to the identical verdict.  A
                          final catch-up sweep runs at cutover, serialized
                          with the flip, over the rows the engine marked
                          touched after their window.
  certified cutover       before the flip, the replica-resolved canary
                          runs ON THE TARGET placement (one replica's veto
                          aborts, `replica-canary-veto`) and an audit sweep
                          re-proves the migrated rows against fresh walks.
                          Only then does the affinity hash flip
                          generation: state, rules, services and
                          forwarding re-place in one host-side swap,
                          published as one mesh-wide epoch swap.  An abort
                          (veto, audit divergence, flip exception) keeps
                          the old mesh serving from the pre-flip snapshot.
  observability           reshard-begin/-migrated/-cutover/-abort
                          flight-recorder kinds, the reshard metric
                          families and a resize span (migrate / certify /
                          cutover stages telescoping to total) on the
                          realization tracer.

Placement on the in-process mesh: the engine holds replica d's state as
one copy per rule shard (state[d][r], kept equal) and its own copy of every
rule shard (a RuleGrid).  Migration reads rule shard 0's copy of each
source replica; the flip builds every target replica's state from the host
mirrors, one copy per rule shard; target rules go through the engine's own
placement hook (`_place_rules_on` -> place_rule_grid), so each target
replica owns its copies and `corrupt_target(r)` flips replica r's alone.

The migrator copies rows field by field over `FlowCache._fields` /
`AffinityTable._fields`; the manifest below names each field's rule, and a
test holds its keys equal to those fields (a field nobody taught the
migrator is a silent flow-loss bug).

Tenant worlds (datapath/tenancy.py) ride the whole walk, per world: each
world gets its own `_WorldMigration` record (host mirrors, dirty bitmap,
striped cursor at the WORLD's width and slot rung), the budgeted task
splits its tick budget evenly over the default world and every live world,
and the cutover certifies PER TENANT: one world's veto latches ONLY that
world (journaled `tenant-rollback` + `tenant-reshard-veto`; it keeps
serving its old topology through the per-world `_mesh` / `_n_data` /
`_topo_gen` latch in `_TENANT_WORLD_FIELDS`, re-homed later by
`tenant_reshard_resync`) while certified worlds flip
(`tenant-reshard-cutover`); only the DEFAULT world's veto aborts the fleet.

Documented residue: a row evicted or idle-expired in the OLD topology
between its migration window and the cutover catch-up can survive in the
target table.  This is verdict-safe by construction (liveness and
generation validity are re-checked at every lookup, and a resurrected
committed row serves what it served before its eviction).  Second residue:
a world still LATCHED from an earlier veto when the next resize begins
migrates from its own (old) topology with no skip mapping onto the
fleet's; any row that cannot land re-misses to an identical verdict.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..compiler.compile import ACT_ALLOW
from ..models import pipeline as pl
from ..observability.flightrec import emit_into
from ..utils import ip as iputil
from .mesh import LocalMesh, local_mesh, shard_of_tuples

# Migration rule per per-replica state field, keyed "Class.field".  A pure
# literal (the analysis pass `reshard` parses it with ast.literal_eval):
# every field of FlowCache / AffinityTable must carry a rule, and every
# rule must name such a field.
RESHARD_MANIFEST = {
    "FlowCache.keys": "row-migrate to (target-ring home, SAME local slot "
                      "— the cache slot hash is D-independent); the key "
                      "row carries the occupancy/validity bit",
    "FlowCache.meta": "row-migrate with its key row (verdict, DNAT "
                      "resolution, rule attribution, SNAT/DSR/CONF marks)",
    "FlowCache.ts": "row-migrate; newest-ts wins direct-mapped collisions "
                    "(shrink merges two source replicas into one slot)",
    "FlowCache.pkts": "row-migrate (low limb of the 64-bit per-direction "
                      "packet counter)",
    "FlowCache.pkts_hi": "row-migrate (carry limb; rides its low limb)",
    "FlowCache.octets": "row-migrate (low limb of the byte counter)",
    "FlowCache.octets_hi": "row-migrate (carry limb; rides its low limb)",
    "AffinityTable.key_client": "broadcast to EVERY target replica at the "
                                "same slot: affinity rows self-identify "
                                "by client key and the flow's home shard "
                                "is not derivable from the row (ports "
                                "are not stored), so stickiness is "
                                "preserved wherever the client lands; "
                                "newest-ts wins collisions",
    "AffinityTable.key_svc": "broadcast with its client key",
    "AffinityTable.ep": "broadcast (the sticky endpoint choice; "
                        "occupancy = ep > 0)",
    "AffinityTable.ts": "broadcast; newest-ts wins collisions",
}

# Migration rule per per-replica member of the mesh engine's
# _TENANT_WORLD_FIELDS (parallel/meshpath.py): the same pure-literal
# contract as RESHARD_MANIFEST, one level up (a world field nobody taught
# the migrator is a silent per-tenant flow-loss bug).
WORLD_MIGRATION = {
    "_state": "per-world row-migrate under _world_ctx: the tenant salt "
              "keeps shard_of_tuples(tenant=) generation-composable, so "
              "each world's FlowCache rows re-home by the "
              "RESHARD_MANIFEST rules with the world's own host mirrors "
              "and dirty bitmap; AffinityTable rows broadcast",
}


def _replica_shapes(state) -> tuple[dict, dict]:
    """One replica's per-field table shapes (rule shard 0's copy of replica
    0: every copy has the same shapes) -> (flow shapes, aff shapes)."""
    st = state[0][0]
    return ({n: tuple(getattr(st.flow, n).shape) for n in pl.FlowCache._fields},
            {n: tuple(getattr(st.aff, n).shape)
             for n in pl.AffinityTable._fields})


def _host_state(flow_host: dict, aff_host: dict, r: int) -> pl.PipelineState:
    """Replica r of the host mirrors as a numpy PipelineState."""
    return pl.PipelineState(
        flow=pl.FlowCache(**{n: flow_host[n][r] for n in pl.FlowCache._fields}),
        aff=pl.AffinityTable(**{n: aff_host[n][r]
                                for n in pl.AffinityTable._fields}))


def _place_state(flow_host: dict, aff_host: dict, mesh: LocalMesh) -> tuple:
    """The host mirrors -> the engine's state on `mesh`: every replica's
    tables on mesh.device, one copy per rule shard (state[d][r])."""
    return tuple(
        tuple(pl.state_from_numpy(_host_state(flow_host, aff_host, d),
                                  mesh.device) for _ in range(mesh.n_rule))
        for d in range(mesh.n_data))


class _WorldMigration:
    """Per-tenant-world migration record: ONE world's host mirrors,
    dirty bitmap and striped cursor, at the WORLD's width/generation and
    slot rung (quota-rung tables are smaller than the fleet's).  The
    plane's own migration methods take `mig=` and route all per-world
    reads/writes through this record — the default world's record IS the
    plane itself (identical attribute names), so the untenanted path is
    provably the pre-existing one."""

    def __init__(self, tenant: int, fields: dict, plane) -> None:
        self.tenant = int(tenant)
        self.src_n = int(fields["_n_data"])
        self.src_gen = int(fields["_topo_gen"])
        self.dst_n = int(plane.dst_n)
        self.gen = int(plane.gen)
        # Skip-replica (evacuation) index is TOPOLOGY-RELATIVE: a world
        # latched behind its own survivor mask carries the dead index in
        # its _fo_mask latch; a fleet-aligned world shares the plane's;
        # a world latched from an EARLIER resize has no mapping (the
        # module docstring's second residue) and migrates all replicas.
        wm = fields.get("_fo_mask")
        if wm is not None:
            self.skip = int(wm[0])
        elif (plane.skip is not None and self.src_n == plane.src_n
                and self.src_gen == int(plane.owner._topo_gen)):
            self.skip = int(plane.skip)
        else:
            self.skip = None
        self.slots = int(fields["_meta"].flow_slots)
        self.G = self.src_n * self.slots
        self.covered = 0
        self.dirty = np.zeros((self.src_n, self.slots), bool)
        self.dirty_all = False
        flow, aff = _replica_shapes(fields["_state"])
        self.flow_host = {name: np.zeros((self.dst_n,) + flow[name], np.int32)
                          for name in pl.FlowCache._fields}
        self.aff_host = {name: np.zeros((self.dst_n,) + aff[name], np.int32)
                         for name in pl.AffinityTable._fields}
        self.t_drs = None
        self.t_match_meta = None
        self._t_rules_gen = -1
        self.migrated_rows = 0
        self.resident_rows = 0
        self.catchup_rows = 0
        self.catchup_scanned = 0
        self.aff_rows = 0
        self.certify_divergences = 0
        self.vetoed = False
        self.flipped = False


class ReshardPlane:
    """One live data-axis resize of a `MeshDatapath` (the owner).

    Single-threaded like every plane it composes with: migration windows
    and the cutover run inside the maintenance scheduler's tick (ONE
    serialization point — never concurrent with an in-flight drain), and
    the old topology serves every packet until the certified flip.
    """

    def __init__(self, owner, n_data: int, devices=None,
                 skip_replica=None):
        if n_data <= 0:
            raise ValueError(f"target data-axis size must be positive, "
                             f"got {n_data}")
        if int(n_data) == owner._n_data:
            raise ValueError(
                f"target data-axis size {n_data} equals the current one — "
                f"nothing to reshard")
        if skip_replica is not None and not (
                0 <= int(skip_replica) < owner._n_data):
            raise ValueError(
                f"skip_replica {skip_replica} out of range for "
                f"{owner._n_data} source replicas")
        # Emergency-evacuation mode (parallel/failover.py): NO source
        # migration from this quarantined source replica — its rows may
        # be arbitrarily corrupt, and its established flows re-miss at
        # their survivor-ring home and re-classify to the identical
        # verdict (the lost-update guard's verdict-safety argument).
        self.skip = None if skip_replica is None else int(skip_replica)
        self.owner = owner
        self.src_n = int(owner._n_data)
        self.dst_n = int(n_data)
        # The next affinity-hash generation: generation 0 is the boot
        # dense map; every resized topology elects on the consistent
        # ring (mesh.shard_of_tuples), so consecutive resizes move only
        # the ring-minimal key fraction.
        self.gen = int(owner._topo_gen) + 1
        # local_mesh raises when the device pool cannot host D' x R.
        self.t_mesh = local_mesh(self.dst_n, owner._n_rule,
                                 owner._mesh.device, devices)
        # Target rule placement is built lazily at certification time
        # (gen-checked), so bundles landing mid-migration are absorbed.
        self.t_drs = None
        self.t_match_meta = None
        self._t_rules_gen = -1
        # HOST mirrors of the target state tables: migration scatters
        # land here (row-at-a-time host writes, no device round trips);
        # the flip places them on the target mesh in one upload per table.
        flow, aff = _replica_shapes(owner._state)
        self.flow_host = {name: np.zeros((self.dst_n,) + flow[name], np.int32)
                          for name in pl.FlowCache._fields}
        self.aff_host = {name: np.zeros((self.dst_n,) + aff[name], np.int32)
                         for name in pl.AffinityTable._fields}
        # Striped migration cursor over the GLOBAL source slot space
        # (g -> replica g % D, local slot g // D — the audit striping),
        # so every budgeted window advances all source replicas.
        self.G = self.src_n * int(owner._meta.flow_slots)
        self.covered = 0
        # Dirty-row tracking: the engine records every (replica, local
        # slot) a live dispatch may
        # have committed/refreshed/torn down while this resize is in
        # flight (MeshDatapath._note_reshard_touched), and the cutover
        # catch-up sweeps ONLY that set instead of re-walking all G
        # slots.  A boolean BITMAP, not a set: note_touched sits on the
        # live dispatch path, so marking must be one vectorized
        # fancy-index write (memory bounded at 1 bit/slot).  `dirty_all`
        # is the escape hatch: a mid-resize attribution remap touches
        # the whole cache, so the sweep falls back to the full walk
        # (metered either way via catchup_scanned ->
        # reshard_catchup_rows_total).
        self.dirty = np.zeros(
            (self.src_n, int(owner._meta.flow_slots)), bool)
        self.dirty_all = False
        self.catchup_scanned = 0
        # The default world's migration record IS the plane (the _copy_
        # rows/_catchup family routes through `mig` attributes with these
        # exact names — see _WorldMigration).
        self.tenant = 0
        self.slots = int(owner._meta.flow_slots)
        self.vetoed = False
        self.flipped = False
        # One _WorldMigration per LIVE tenant world, built from the
        # world's exported field snapshot (w.fields — no _world_ctx
        # needed at begin time).  Worlds created mid-resize join via
        # note_world_created.
        self.worlds = {}
        reg = getattr(owner, "_tenants", None)
        if reg is not None:
            for tid in sorted(reg.worlds):
                self.worlds[int(tid)] = _WorldMigration(
                    int(tid), reg.worlds[tid].fields, self)
        self.phase = "migrate"  # -> "ready" -> done/aborted
        self.done = False
        self.aborted = False
        self.migrated_rows = 0
        self.resident_rows = 0
        self.catchup_rows = 0
        self.aff_rows = 0
        self.certify_divergences = 0
        # Resize span stamps (the realization-span shape: stages clamp
        # monotonic and telescope to total) on the commit plane's clock.
        self._clock = getattr(owner._commit, "_clock", None) or time.monotonic
        self._stamps = {"begin": float(self._clock())}
        extra = {} if self.skip is None else {"skip_replica": self.skip}
        self._emit("reshard-begin", topo_gen_target=self.gen,
                   n_data_from=self.src_n, n_data_to=self.dst_n,
                   slots=self.G, tenant_worlds=len(self.worlds), **extra)

    # -- plumbing ------------------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        emit_into(self.owner, kind, **fields)

    def _mig_for(self, tenant: int):
        """The migration record a tenant id routes to: the plane itself
        for the default world, the world's _WorldMigration otherwise
        (None for a world the plane does not track — begin-time race,
        harmless: its rows re-miss to identical verdicts)."""
        return self if tenant == 0 else self.worlds.get(int(tenant))

    def note_touched(self, replica, slots, tenant: int = 0) -> None:
        """Record source-(replica, local slot) pairs a live dispatch may
        have written (conservative over-marking is harmless: the
        catch-up re-sweeps one already-synced row).  One masked
        fancy-index write — this runs on the traffic path.  Per-world
        dispatches route to the world's own bitmap (replica/slot are in
        the WORLD's indexing)."""
        mig = self._mig_for(tenant)
        if mig is None or mig.dirty_all:
            return
        rep = np.asarray(replica).ravel()
        sl = np.asarray(slots).ravel()
        ok = ((rep >= 0) & (rep < mig.dirty.shape[0])
              & (sl >= 0) & (sl < mig.dirty.shape[1]))
        mig.dirty[rep[ok], sl[ok]] = True

    def note_all_dirty(self, tenant: int = 0) -> None:
        """Whole-cache write (attribution remap): bounded tracking can't
        cover it — the catch-up falls back to the full sweep (for the
        one world that remapped, not the fleet)."""
        mig = self._mig_for(tenant)
        if mig is None:
            return
        mig.dirty_all = True
        mig.dirty[:] = False

    def dirty_all_for(self, tenant: int = 0) -> bool:
        """True when the tenant's catch-up already degraded to the full
        walk (or the plane does not track the world) — the engine's
        dirty-note fast-path check."""
        mig = self._mig_for(tenant)
        return True if mig is None else bool(mig.dirty_all)

    def note_world_created(self, tid: int, world) -> None:
        """A tenant world created MID-RESIZE joins the walk: its record
        starts at zero coverage, and the cutover migrates it
        synchronously if the budgeted windows don't reach it first."""
        if self.done or self.aborted:
            return
        self.worlds[int(tid)] = _WorldMigration(int(tid), world.fields,
                                                self)

    def tenant_rows(self) -> int:
        """Rows migrated across all tenant worlds so far (the fleet
        meters the default world separately)."""
        return sum(int(w.migrated_rows) for w in self.worlds.values())

    def _stamp(self, name: str) -> None:
        prev = max(self._stamps.values())
        self._stamps[name] = max(float(self._clock()), prev)

    def status(self) -> dict:
        return {
            "phase": "aborted" if self.aborted else (
                "done" if self.done else self.phase),
            "topo_gen_target": self.gen,
            "n_data_from": self.src_n,
            "n_data_to": self.dst_n,
            "progress_ratio": round(self.covered / max(self.G, 1), 4),
            "migrated_rows": int(self.migrated_rows),
            "resident_rows": int(self.resident_rows),
            "catchup_rows": int(self.catchup_rows),
            "catchup_scanned": int(self.catchup_scanned),
            "dirty_rows": int(self.dirty.sum()),
            "dirty_all": bool(self.dirty_all),
            "affinity_rows": int(self.aff_rows),
            "tenant_worlds": len(self.worlds),
            "tenant_rows": int(self.tenant_rows()),
            "tenant_vetoes": sum(
                1 for w in self.worlds.values() if w.vetoed),
        }

    # -- the maintenance-task entry point ------------------------------------

    def advance(self, now: int, budget: int) -> int:
        """One budgeted round -> units spent (slots scanned + probes).
        Migration windows honor `budget`; the cutover round reports its
        TRUE cost unclamped — the scheduler's overrun path clamps the
        accounting and meters it, the canary/scrub discipline."""
        if self.done or self.aborted:
            return 0
        if self.phase == "migrate":
            # The tick budget splits EVENLY over every world still
            # migrating (default world first); each world's window runs
            # under its _world_ctx so the world's own state/meta are the
            # active ones.  max(1, ...) keeps tiny budgets progressing —
            # the scheduler's overrun meter prices the spill honestly.
            pend = []
            if self.covered < self.G:
                pend.append(None)
            pend += [tid for tid in sorted(self.worlds)
                     if self.worlds[tid].covered < self.worlds[tid].G]
            spent = 0
            o = self.owner
            for i, tid in enumerate(pend):
                share = max(
                    1, (max(int(budget), 0) - spent) // (len(pend) - i))
                if tid is None:
                    spent += self._migrate_window(now, share)
                else:
                    mig = self.worlds[tid]
                    with o._world_ctx(tid):
                        spent += self._migrate_window(now, share, mig=mig)
            if self.covered >= self.G and all(
                    w.covered >= w.G for w in self.worlds.values()):
                self.phase = "ready"
                self._stamp("migrated")
                self._emit("reshard-migrated", rows=int(self.migrated_rows),
                           resident=int(self.resident_rows),
                           slots=int(self.G),
                           tenant_rows=int(self.tenant_rows()), at=int(now))
            return spent
        # phase == "ready": certified cutover.  Degradation pauses the
        # flip (shed_when_degraded on the task is the first gate; this is
        # the belt for a degrade landing between shed check and run) —
        # the cutover gate could never certify against a degraded plane.
        if self.owner.degraded:
            return 0
        return self._cutover(now)

    # -- drain-and-migrate ---------------------------------------------------

    def _migrate_window(self, now: int, budget: int, mig=None) -> int:
        """Walk `budget` global slots from the striped cursor, migrating
        every live row to its target-ring home -> slots scanned.  With
        `mig`, the walk is one tenant world's (run under its _world_ctx
        so `owner._state` is the world's)."""
        mig = self if mig is None else mig
        D = mig.src_n
        cursor = mig.covered
        k = min(max(int(budget), 0), mig.G - cursor)
        if k <= 0:
            return 0
        for r in range(D):
            if r == mig.skip:
                continue  # quarantined source: nothing migrates from it
            first = cursor + ((r - cursor) % D)
            if first >= cursor + k:
                continue
            count = (cursor + k - first + D - 1) // D
            self._copy_rows(r, first // D, count, now, mig=mig)
        mig.covered += k
        return k

    def _copy_rows(self, r: int, ls: int, count: int, now: int,
                   catchup: bool = False, mig=None, host=None) -> int:
        """Decode `count` consecutive local slots of source replica `r`
        and re-commit the live rows into the target host mirror.

        Host-loop implementation (one transfer per column per window,
        per-row collision resolution): simple and provably bitwise, and
        the budget meter prices it honestly.  A faster path (one window
        transfer + a vectorized (home, slot, ts)-sorted scatter) is
        optimization work left for later.  `host`: replica r's flow
        tables already read to the host (_host_flow), sliced instead of
        the card's."""
        mig = self if mig is None else mig
        o = self.owner
        if host is None:
            # Rule shard 0's copy of the replica (the copies are equal).
            flow = o._state[r][0].flow
            cols = {name: getattr(flow, name)[ls:ls + count].cpu().numpy()
                    for name in pl.FlowCache._fields}
        else:
            cols = {name: host[name][ls:ls + count]
                    for name in pl.FlowCache._fields}
        keys = cols["keys"].astype(np.int64)
        meta = cols["meta"].astype(np.int64)
        live, _egen = o._live_mask(keys, meta, cols["ts"], now)
        idx = np.nonzero(live)[0]
        if idx.size == 0:
            return 0
        A = o._meta.key_words - 2
        kpg = keys[:, A + 1]
        src_u = iputil.unflip_u32_array(cols["keys"][:, 0])
        dst_u = iputil.unflip_u32_array(cols["keys"][:, 1])
        pp = keys[:, A]
        sport = ((pp >> 16) & 0xFFFF).astype(np.int32)
        dport = (pp & 0xFFFF).astype(np.int32)
        proto = (kpg & 0xFF).astype(np.int32)
        # The stored key IS the direction the packets arrive with (reply
        # rows are keyed on the reply tuple), and the affinity hash is
        # direction-symmetric — so hashing the stored tuple homes every
        # row exactly where its own lookups will land.  The tenant salt
        # composes: a world's rows re-home on the world's OWN ring.
        home = shard_of_tuples(src_u, dst_u, proto, sport, dport,
                               mig.dst_n, mig.gen, tenant=mig.tenant)
        moved = 0
        t = mig.flow_host
        for i in idx:
            i = int(i)
            r2, slot = int(home[i]), ls + i
            ts_new = int(cols["ts"][i])
            # Newest-ts wins direct-mapped collisions; TIES overwrite, so
            # the cutover catch-up re-syncs rows whose content changed
            # without a ts refresh (e.g. a mid-resize bundle's
            # attribution remap).
            if int(t["keys"][r2, slot, -1]) != 0:
                if int(t["ts"][r2, slot]) > ts_new:
                    continue
            else:
                mig.resident_rows += 1
            for name in pl.FlowCache._fields:
                t[name][r2, slot] = cols[name][i]
            moved += 1
        mig.migrated_rows += moved
        if catchup:
            mig.catchup_rows += moved
        return moved

    def _host_flow(self, r: int) -> dict:
        """Source replica r's whole flow tables on the host (rule shard 0's
        copy), one read per table."""
        flow = self.owner._state[r][0].flow
        return {name: getattr(flow, name).cpu().numpy()
                for name in pl.FlowCache._fields}

    def _migrate_affinity(self, mig=None) -> int:
        """Broadcast every occupied affinity row to all target replicas
        at the same slot (see the manifest rationale) -> rows copied."""
        mig = self if mig is None else mig
        o = self.owner
        t = mig.aff_host
        moved = 0
        for r in range(mig.src_n):
            if r == mig.skip:
                # Sticky choices held only by the quarantined replica are
                # lost — re-election is verdict-safe (affinity drift sits
                # outside the certification veto by design).
                continue
            aff = o._state[r][0].aff
            cols = {name: getattr(aff, name).cpu().numpy()
                    for name in pl.AffinityTable._fields}
            for i in np.nonzero(cols["ep"][:-1] > 0)[0]:
                i = int(i)
                ts_new = int(cols["ts"][i])
                for r2 in range(mig.dst_n):
                    if t["ep"][r2, i] > 0 and int(t["ts"][r2, i]) > ts_new:
                        continue
                    for name in pl.AffinityTable._fields:
                        t[name][r2, i] = cols[name][i]
                moved += 1
        mig.aff_rows = moved
        return moved

    def _catchup(self, now: int, mig=None) -> int:
        """The final delta sweep, serialized with the flip (the
        scheduler's tick already excludes in-flight drains, and no
        traffic steps between this sweep and the generation flip in the
        single-threaded engine): re-sync rows committed, refreshed or
        torn down AFTER their migration window so they land in the
        target before it serves.  Idempotent by the newest-ts/
        tie-overwrite rule.  Affinity broadcasts here too — one pass at
        the freshest view.

        Sweeps ONLY the engine-recorded dirty set (note_touched) —
        consecutive dirty slots coalesce into one decode window — and
        falls back to the full O(slots) walk only after a whole-cache
        write (dirty_all: the mid-resize attribution remap).  Swept
        volume is metered (catchup_scanned ->
        antrea_tpu_reshard_catchup_rows_total)."""
        mig = self if mig is None else mig
        S = mig.slots
        if mig.dirty_all:
            for r in range(mig.src_n):
                if r == mig.skip:
                    continue
                self._copy_rows(r, 0, S, now, catchup=True, mig=mig)
            mig.catchup_scanned += mig.G
            return mig.G + self._migrate_affinity(mig=mig)
        scanned = 0
        for r in range(mig.src_n):
            if r == mig.skip:
                mig.dirty[r] = False
                continue
            slots = np.flatnonzero(mig.dirty[r, :S])
            # The replica's tables are read once for all its runs: nothing
            # writes them between this sweep and the flip.
            host = self._host_flow(r) if slots.size else None
            # Consecutive dirty slots coalesce into one decode window.
            for run in np.split(slots,
                                np.flatnonzero(np.diff(slots) > 1) + 1):
                if run.size == 0:
                    continue
                self._copy_rows(r, int(run[0]), int(run.size), now,
                                catchup=True, mig=mig, host=host)
                scanned += int(run.size)
            mig.dirty[r] = False
        mig.catchup_scanned += scanned
        return scanned + self._migrate_affinity(mig=mig)

    # -- certification -------------------------------------------------------

    def _ensure_target_rules(self) -> None:
        """(Re)place the rule tensors on the target mesh — lazily and
        generation-checked, so bundles/deltas landing mid-migration are
        absorbed into what the canary actually certifies (and what the
        flip actually serves: certify-what-you-serve)."""
        o = self.owner
        if self.t_drs is not None and self._t_rules_gen == o._gen:
            return
        # The engine's own placement hook on the target mesh: each target
        # replica gets its own copy of every rule shard.
        drs, _meta = o._place_rules_on(self.t_mesh, o._cps)
        if o._n_deltas:
            # Pending O(delta) slot rows ride onto the target placement
            # from the host mirror — the fold the audit self-heal uses.
            drs = o._grid_with_delta(drs, o._build_delta_table())
        self.t_drs = drs
        # The LIVE match meta (it carries the current prune K rung; the
        # tables are K-independent, so placement and meta stay coherent
        # across retunes).
        self.t_match_meta = o._meta.match
        self._t_rules_gen = int(o._gen)

    def corrupt_target(self, replica: int) -> str:
        """Chaos helper (the corrupt_replica twin for the TARGET
        placement): flip the rule-side copies held by one target data
        replica's devices, so the cutover canary's row for exactly that
        replica diverges and vetoes the flip."""
        self._ensure_target_rules()
        self.t_drs = self.owner._flip_replica_rules(self.t_drs, int(replica))
        return (f"flipped target rule-side device copies held by data "
                f"replica {replica}")

    def _certify(self, now: int) -> tuple[bool, int]:
        """The cutover gate -> (certified, units spent).  (1) the commit
        canary, replica-resolved on the TARGET placement — one replica's
        veto aborts; (2) a striped audit sweep re-proving the migrated
        rows (committed rows held to the audit's structural invariant,
        affinity-bearing rows outside the veto, the audit discipline)."""
        o = self.owner
        self._ensure_target_rules()
        cost = 0
        cp = o._commit
        if cp is not None and cp.probes > 0:
            o._reshard_canary = (self.t_mesh, self.t_drs,
                                 self.t_match_meta, self.dst_n)
            try:
                mism = cp._canary()
            finally:
                o._reshard_canary = None
            cost += cp.probes
            if mism:
                self.abort(
                    f"target-topology canary veto: {mism[0]}"[:200])
                return False, cost
        div, rows = self._audit_target(now)
        cost += rows
        if div:
            self.certify_divergences = div
            self.abort(f"target-topology audit found {div} divergent "
                       f"migrated row(s)")
            return False, cost
        return True, cost

    def _audit_target(self, now: int, mig=None) -> tuple[int, int]:
        """Re-prove every migrated row against a fresh walk through the
        current tables -> (divergences, rows audited)."""
        mig = self if mig is None else mig
        o = self.owner
        div = rows_total = 0
        for r2 in range(mig.dst_n):
            rows = o._decode_audit_rows(
                torch.from_numpy(mig.flow_host["keys"][r2, :-1]),
                torch.from_numpy(mig.flow_host["meta"][r2, :-1]),
                torch.from_numpy(mig.flow_host["ts"][r2, :-1]),
                now,
                lambda i, r2=r2: i * mig.dst_n + r2,
            )
            if not rows:
                continue
            # The migrated replica's tables on the card, walked against
            # the live rules (the fresh re-proof's tables).
            local = pl.state_from_numpy(
                _host_state(mig.flow_host, mig.aff_host, r2), o._device)
            fresh = o._audit_fresh_state(local, rows, now)
            rows_total += len(rows)
            for row, f in zip(rows, fresh):
                if row["committed"] or row["reply"]:
                    # The audit's structural invariant: a conntrack-committed or
                    # reply entry MUST cache ALLOW — never diffed against
                    # a fresh walk (it legitimately outlives policy).
                    if row["code"] != ACT_ALLOW:
                        div += 1
                elif row["aff"]:
                    continue  # session-affinity drift, outside the veto
                elif row["code"] != f["code"]:
                    div += 1
        return div, rows_total

    # -- per-world certification ---------------------------------------------

    def _ensure_world_rules(self, mig) -> None:
        """(Re)place ONE world's rule tensors on the target mesh — must
        run inside the world's _world_ctx.  Goes through the owner's
        `_place_rules_on` hook (host build + entry-axis RUNG padding +
        the grid on the target mesh), so rung-shared shapes survive the
        resize.  Lazy and generation-checked like the default world's."""
        o = self.owner
        if mig.t_drs is not None and mig._t_rules_gen == int(o._gen):
            return
        drs, _meta = o._place_rules_on(self.t_mesh, o._cps)
        if o._n_deltas:
            drs = o._grid_with_delta(drs, o._build_delta_table())
        mig.t_drs = drs
        mig.t_match_meta = o._meta.match
        mig._t_rules_gen = int(o._gen)

    def _certify_world(self, mig, now: int) -> bool:
        """ONE world's cutover gate — must run inside its _world_ctx.
        The world's own replica-resolved canary runs on the target
        placement (via the owner's `_reshard_canary` redirect, so probes
        resolve against the world's policy set and scalar oracle) and
        its migrated rows re-audit.  A veto latches ONLY this world
        (`_veto_world`) — the fleet and every certified sibling flip
        regardless.  A FaultPlan armed via `arm_reshard_faults` can
        force a deterministic veto at site `{name}.tenant_canary.t{id}`
        (the chaos tier's single-world abort)."""
        o = self.owner
        reason = None
        try:
            self._ensure_world_rules(mig)
        except Exception as e:  # noqa: BLE001 — placement failure must
            # veto the world, never strand the fleet cutover.
            self._veto_world(
                mig, f"target placement failed "
                     f"({type(e).__name__}: {e})", now)
            return False
        pf = getattr(o, "_reshard_faults", None)
        if pf is not None:
            plan, name = pf
            rule = plan.fire(f"{name}.tenant_canary.t{mig.tenant}")
            if rule is not None:
                reason = f"forced tenant-canary veto ({rule.kind})"
        if reason is None:
            cp = o._commit
            if cp is not None and cp.probes > 0:
                o._reshard_canary = (self.t_mesh, mig.t_drs,
                                     mig.t_match_meta, mig.dst_n)
                try:
                    mism = cp._canary()
                finally:
                    o._reshard_canary = None
                if mism:
                    reason = (f"target-topology canary veto: "
                              f"{mism[0]}")[:200]
        if reason is None:
            div, _rows = self._audit_target(now, mig=mig)
            if div:
                mig.certify_divergences = div
                reason = (f"target-topology audit found {div} divergent "
                          f"migrated row(s)")
        if reason is not None:
            self._veto_world(mig, reason, now)
            return False
        return True

    def _veto_world(self, mig, reason: str, now: int) -> None:
        """One world's certification failed: latch it (it keeps serving
        its old topology — `_flip_world` pins the per-world survivor
        mask on an evacuation) and journal the per-tenant rollback
        chain.  Never aborts the fleet."""
        o = self.owner
        mig.vetoed = True
        self.vetoed = True
        w = o._tenants.world(mig.tenant)
        w.rollbacks += 1
        w.reshard_vetoes += 1
        o._reshard_tenant_vetoes += 1
        self._emit("tenant-rollback", tenant=int(mig.tenant),
                   error=f"reshard: {reason}"[:200])
        self._emit("tenant-reshard-veto", tenant=int(mig.tenant),
                   reason=str(reason)[:200], topo_gen_target=int(mig.gen),
                   n_data_to=int(mig.dst_n), at=int(now))

    def _flip_world(self, mig, now: int) -> None:
        """Flip ONE certified world onto the target topology (runs with
        the FLEET already flipped, operating on the world's exported
        field snapshot), or latch a vetoed one.  The latch is the
        per-world topology generation: a vetoed world's `_mesh`/
        `_n_data`/`_topo_gen` fields keep their old values, and on an
        evacuation it additionally pins its own survivor mask
        (`_fo_mask` — the dead index in the WORLD's indexing) so its
        lanes keep avoiding the quarantined replica."""
        o = self.owner
        w = o._tenants.world(mig.tenant)
        f = w.fields
        if mig.vetoed:
            # Evacuation veto: pin the world's own survivor mask only
            # when the dead index is known in the WORLD's indexing
            # (mig.skip) — a world latched from an earlier resize has no
            # mapping (module-docstring residue) and keeps only the
            # generation latch.
            if mig.skip is not None and f.get("_fo_mask") is None:
                f["_fo_mask"] = (int(mig.skip), int(mig.dst_n),
                                 int(mig.gen))
            return
        f["_state"] = _place_state(mig.flow_host, mig.aff_host, self.t_mesh)
        f["_drs"] = mig.t_drs
        f["_mesh"] = self.t_mesh
        f["_n_data"] = int(mig.dst_n)
        f["_topo_gen"] = int(mig.gen)
        f["_replica_audit_entries"] = [0] * int(mig.dst_n)
        f["_fo_mask"] = None
        f["_state_mutations"] = int(f.get("_state_mutations", 0)) + 1
        with o._world_ctx(mig.tenant):
            o._audit_refresh_golden()
        mig.flipped = True
        w.reshard_rows += int(mig.migrated_rows)
        o._reshard_tenant_rows_total += int(mig.migrated_rows)
        self._emit("tenant-reshard-cutover", tenant=int(mig.tenant),
                   topo_gen=int(mig.gen), n_data_from=int(mig.src_n),
                   n_data_to=int(mig.dst_n),
                   migrated_rows=int(mig.migrated_rows),
                   resident_rows=int(mig.resident_rows), at=int(now))

    # -- cutover / abort -----------------------------------------------------

    def _cutover(self, now: int) -> int:
        spent = self._catchup(now)
        ok, cost = self._certify(now)
        spent += cost
        if not ok:
            return spent  # _certify aborted; old mesh keeps serving
        # Per-tenant certification: each world catches up and certifies
        # under its own ctx.  A world's veto latches only that world
        # (_veto_world) — the DEFAULT world's veto above is the only
        # fleet-wide abort.
        o = self.owner
        for tid in sorted(self.worlds):
            mig = self.worlds[tid]
            with o._world_ctx(tid):
                if mig.covered < mig.G:
                    # Created mid-resize after the budgeted windows
                    # finished: migrate synchronously now.
                    spent += self._migrate_window(
                        now, mig.G - mig.covered, mig=mig)
                spent += self._catchup(now, mig=mig)
                self._certify_world(mig, now)
        self._stamp("certified")
        self._flip(now)
        return spent

    def _flip(self, now: int) -> None:
        """The atomic swap: state/rules/services/forwarding re-place on
        the target mesh and the affinity hash flips generation, published
        as ONE mesh-wide epoch swap.  Any exception restores the old mesh
        from the pre-flip snapshot (abort; generation unchanged)."""
        o = self.owner
        sp = o._slowpath
        snap = {
            "mesh": o._mesh, "n_data": o._n_data, "topo_gen": o._topo_gen,
            "state": o._state, "drs": o._drs, "dsvc": o._dsvc,
            "dft": o._dft, "replica_audit": o._replica_audit_entries,
            "queues": (None if sp is None
                       else (sp.n_data, sp.queues, sp.queue)),
            # Shallow copies of every tracked world's field dict: world
            # flips mutate those dicts in place, so a restore swaps the
            # pre-flip copy back wholesale.
            "worlds": {tid: dict(o._tenants.world(tid).fields)
                       for tid in self.worlds},
        }
        try:
            o._mesh = self.t_mesh
            o._n_data = self.dst_n
            o._topo_gen = self.gen
            o._drs = self.t_drs  # the placement the canary CERTIFIED
            # Through the owner's OWN placement hooks (o._mesh already
            # points at the target), so the flip can never drift from
            # whatever layout the hooks define.
            o._dsvc = o._place_services(o._dsvc)
            o._dft = o._place_forwarding(o._dft)
            o._state = _place_state(self.flow_host, self.aff_host,
                                    self.t_mesh)
            o._state_mutations += 1
            o._replica_audit_entries = [0] * self.dst_n
            if o._audit is not None:
                o._audit.cursor = 0  # the striping changed; restart
            o._audit_refresh_golden()
            # Certified worlds flip with the fleet; vetoed ones latch
            # (per-world topology generation + survivor mask).  Before
            # the queue resize so an exception here restores everything.
            for tid in sorted(self.worlds):
                self._flip_world(self.worlds[tid], now)
            # Queue re-home LAST: every raise-capable step is behind us,
            # so a restored snapshot can never strand a resized queue set
            # against an unflipped data axis.
            requeued = dropped = 0
            if sp is not None:
                requeued, dropped = sp.resize(
                    self.dst_n, self._home_of_block, now)
        except Exception as e:  # noqa: BLE001 — the flip must never
            # strand the engine between topologies: restore and abort.
            o._mesh = snap["mesh"]
            o._n_data = snap["n_data"]
            o._topo_gen = snap["topo_gen"]
            o._state = snap["state"]
            o._drs = snap["drs"]
            o._dsvc = snap["dsvc"]
            o._dft = snap["dft"]
            o._replica_audit_entries = snap["replica_audit"]
            for tid, fsnap in snap["worlds"].items():
                o._tenants.world(tid).fields = fsnap
            if sp is not None:
                # Belt for a raise INSIDE resize(): the queue set must
                # match the restored data axis.  Rows already popped for
                # re-homing may drop here — the ordinary bounded-queue
                # contract (the flow re-admits on its next miss), never
                # a verdict loss.
                sp.n_data, sp.queues, sp.queue = snap["queues"]
            self.abort(f"cutover flip failed ({type(e).__name__}: {e}); "
                       f"old mesh restored from the pre-flip snapshot")
            return
        o._reshard_requeued_total += requeued
        if o._slowpath is not None:
            # THE mesh-wide swap: one epoch bump — the next lookup on any
            # replica consumes the re-placed state, never a mix.
            o._slowpath._publish(now)
        self._stamp("cutover")
        span = self._span()
        o._last_reshard_span = span
        if o._realization is not None:
            o._realization.note_resize_span(span)
        self._emit("reshard-cutover", topo_gen=self.gen,
                   n_data_from=self.src_n, n_data_to=self.dst_n,
                   migrated_rows=int(self.migrated_rows),
                   resident_rows=int(self.resident_rows),
                   requeued=int(requeued), dropped=int(dropped),
                   tenant_worlds=len(self.worlds),
                   tenant_rows=int(self.tenant_rows()),
                   tenant_vetoes=sum(
                       1 for w in self.worlds.values() if w.vetoed),
                   at=int(now))
        self.done = True
        o._reshard_cutovers += 1
        o._reshard_migrated_total += self.migrated_rows
        o._reshard_catchup_total += self.catchup_scanned
        o._reshard_resident_rows = self.resident_rows
        o._finish_reshard(self)

    def abort(self, reason: str) -> None:
        """Abandon the resize: the old mesh keeps serving (it never
        stopped), the affinity generation never flips, and every target
        structure is dropped.  Idempotent."""
        if self.done or self.aborted:
            return
        self.aborted = True
        o = self.owner
        o._reshard_aborts += 1
        o._reshard_migrated_total += self.migrated_rows
        o._reshard_catchup_total += self.catchup_scanned
        self._emit("reshard-abort", reason=str(reason)[:200],
                   topo_gen_target=self.gen, n_data_to=self.dst_n,
                   progress=round(self.covered / max(self.G, 1), 4))
        o._finish_reshard(self)

    # -- helpers -------------------------------------------------------------

    def _home_of_block(self, block: dict) -> np.ndarray:
        """Target-ring homes for a popped miss-queue block (the queue
        re-route at flip time), per tenant: the tenant column rides the
        queue rows verbatim, and each world's rows re-home on its OWN
        salted ring.  A LATCHED world's rows get target-ring homes here
        too — the queue index is a transport detail only; the drain
        re-splits per tenant and re-lays rows out on the world's own
        topology at classify time (meshpath._relayout_world_blocks), so
        verdicts never see the fleet indexing."""
        cols = (np.asarray(block["src_ip"]).astype(np.uint32),
                np.asarray(block["dst_ip"]).astype(np.uint32),
                np.asarray(block["proto"]).astype(np.int32),
                np.asarray(block["src_port"]).astype(np.int32),
                np.asarray(block["dst_port"]).astype(np.int32))
        ten = np.asarray(block.get(
            "tenant", np.zeros(cols[0].shape, np.int64)))
        out = np.zeros(cols[0].shape, np.int32)
        for t in np.unique(ten):
            m = ten == t
            out[m] = shard_of_tuples(*(c[m] for c in cols),
                                     self.dst_n, self.gen,
                                     tenant=int(t))
        return out

    def _span(self) -> dict:
        """The resize span: stage durations clamped monotonic,
        telescoping exactly to total (the realization-span shape)."""
        s = self._stamps
        t0 = s["begin"]
        prev = t0
        out = {}
        for name, key in (("migrated", "migrate_s"),
                          ("certified", "certify_s"),
                          ("cutover", "cutover_s")):
            t = max(s.get(name, prev), prev)
            out[key] = t - prev
            prev = t
        out["total_s"] = prev - t0
        out["n_data_from"] = self.src_n
        out["n_data_to"] = self.dst_n
        out["rows_migrated"] = int(self.migrated_rows)
        return out


def resync_world(owner, tid: int, now: int) -> dict:
    """Re-home ONE latched tenant world onto the owner's CURRENT fleet
    topology — the readmission half of a per-world canary veto (the
    world latched at cutover and kept serving its old topology behind
    its generation latch / survivor mask).  A full synchronous
    migrate + catch-up + certify + flip walk for just this world, under
    the same veto rules: a second veto re-latches and journals, never a
    wrong verdict.  `now` must be the live scheduler clock — the
    liveness decode classifies rows against it.

    Entry point: `MeshDatapath.tenant_reshard_resync` (which refuses
    while a fleet resize is in flight — the plane would race this
    walk)."""
    w = owner._tenants.world(int(tid))
    f = w.fields
    if (int(f.get("_n_data", 0)) == int(owner._n_data)
            and int(f.get("_topo_gen", -1)) == int(owner._topo_gen)
            and f.get("_fo_mask") is None):
        return {"tenant": int(tid), "resynced": 0,
                "reason": "fleet-aligned"}
    # A minimal plane shim: target = the CURRENT fleet topology, no
    # fleet-side migration state (G=covered so the default record is
    # inert), reusing the per-world machinery verbatim.
    p = ReshardPlane.__new__(ReshardPlane)
    p.owner = owner
    p.skip = None
    p.src_n = int(owner._n_data)
    p.dst_n = int(owner._n_data)
    p.gen = int(owner._topo_gen)
    p.t_mesh = owner._mesh
    p.t_drs = None
    p.t_match_meta = None
    p._t_rules_gen = -1
    p.tenant = 0
    p.slots = int(owner._meta.flow_slots)
    p.vetoed = False
    p.flipped = False
    p.worlds = {}
    p.G = 1
    p.covered = 1
    p.dirty = np.zeros((1, 1), bool)
    p.dirty_all = False
    p.flow_host = {}
    p.aff_host = {}
    p.migrated_rows = 0
    p.resident_rows = 0
    p.catchup_rows = 0
    p.catchup_scanned = 0
    p.aff_rows = 0
    p.certify_divergences = 0
    p.phase = "ready"
    p.done = False
    p.aborted = False
    p._clock = getattr(owner._commit, "_clock", None) or time.monotonic
    p._stamps = {"begin": float(p._clock())}
    mig = _WorldMigration(int(tid), f, p)
    with owner._world_ctx(tid):
        p._migrate_window(now, mig.G, mig=mig)
        p._catchup(now, mig=mig)
        ok = p._certify_world(mig, now)
    if not ok:
        return {"tenant": int(tid), "resynced": 0, "reason": "veto",
                "vetoed": 1}
    fsnap = dict(f)
    try:
        p._flip_world(mig, now)
    except Exception as e:  # noqa: BLE001 — restore; the world keeps
        # its latch and old topology, journaled.
        w.fields = fsnap
        emit_into(owner, "tenant-rollback", tenant=int(tid),
                  error=f"resync flip: {type(e).__name__}: {e}"[:200])
        return {"tenant": int(tid), "resynced": 0,
                "reason": "flip-failed"}
    return {"tenant": int(tid), "resynced": 1,
            "migrated_rows": int(mig.migrated_rows),
            "topology_generation": int(p.gen), "n_data": int(p.dst_n)}
