"""Multi-tenant serving plane: many isolated policy worlds on one slice.

The reference dedicates a control plane per cluster yet still ships 26k
LoC of multicluster machinery and a label -> cluster-wide-ID index
(SURVEY 1-L8, pkg/controller/labelidentity; multicluster/) precisely
because real deployments are many-world.  Production SaaS serves
thousands of tenants on shared accelerators; this plane packs N
independent rule worlds into one datapath instance — either engine, and
the mesh — with three hard guarantees:

  SHARED COMPILES   every tenant's rule world is padded onto pow2 RUNGS
                    before placement: phase capacities
                    (compiler/compile.pad_compiled_phases — the static
                    jit signature carries per-phase rule counts), rule
                    words (the existing `_width` pow2 of the padded
                    counts), and the per-dimension interval-boundary
                    axes (ops/match.pad_ruleset_entries).  Two tenants
                    on the same rung produce IDENTICAL tensor shapes
                    and static metas, so jax serves them from ONE
                    compiled program — executable count is bounded by
                    occupied rungs, never by tenant count (the pow2
                    ladder pattern applied to whole rule worlds;
                    asserted over 64 uneven tenants in
                    tests/test_tenancy.py).  Logically the registry
                    maintains one GLOBAL rule-word axis — tenant t owns
                    the word window [word_off, word_off + words) riding
                    the existing rule-axis word sharding; physically
                    each window is materialized as its own rung-shaped
                    tensors (the block-diagonal pack with the zero
                    blocks elided — slicing a block-diagonal pack and
                    holding per-window tensors are the same bytes).

  TENANT-KEYED STATE  the tenant id joins every 5-tuple keyed surface:
                    the flow-cache slot and affinity hashes select the
                    tenant's OWN state tensors (disjoint per-tenant
                    tables at pow2 quota rungs — the strongest form of
                    "tenant id in the hash": no cross-tenant collision
                    exists even adversarially), the mesh shard hash
                    folds the tenant id as a salt
                    (parallel/mesh.shard_of_tuples(tenant=)), and the
                    miss queue carries a tenant column so drains
                    classify every row in its owner's world
                    (analysis pass `tenant` gates all three surfaces).

  ISOLATION         per-tenant flow-cache quotas are structural (a
                    tenant's churn storm can only evict rows of its own
                    rung-sized tables) and the shared miss queue is
                    guarded by a per-tenant in-queue quota CLAMP
                    (metered + journaled) so one tenant's attack storm
                    cannot monopolize slow-path admission.  Commit
                    generations are per tenant: an install runs the
                    full commit-plane transaction (compile -> canary -> swap ->
                    settle) inside the tenant's world, so a canary veto
                    rolls back — and degrades — ONLY that tenant; every
                    other tenant's generation, LKG and serving state
                    are untouched.

Mechanically the plane is a WORLD SWAP: `TenantWorld` captures the
complete per-world field set of an engine (`_TENANT_WORLD_FIELDS` on
each engine class — analysis pass `tenant` pins the required members),
plus the commit plane's per-world slice (degraded/LKG), the audit
plane's golden digests and the slow-path staleness flag.  `_world_ctx`
swaps a world in, runs the ordinary engine machinery — step, install,
drain, canary, rollback — and swaps it back out; the default world
(tenant id 0) is the engine's own untenanted state and is bit-identical
to a tenancy-free build.  Shared, deliberately NOT per-tenant: the
service view, topology/forwarding tables, the maintenance scheduler,
flight recorder and the prune plane (tenant policies with toServices
references are rejected — a shared-service recompile could not reach
them; documented residue with per-tenant realization tracing and the
tensor scrub, which serve the default world only).  Tenant worlds ARE
restart-persistent: each world's INPUT state (spec + policy set +
generation) rides the two-slot checksummed snapshot
(datapath/persist.py) and the registry rebuilds — tids and generations
preserved, tensors recompiled, caches re-classifying — at the end of a
persist-dir boot (`_restore_tenant_worlds`).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..compiler.compile import pad_compiled_phases
from ..compiler.ir import PolicySet
from ..config import ConfigError
from ..observability.flightrec import emit_into
from ..ops.match import pad_ruleset_entries

# Default per-tenant flow-cache quota (slots; pow2 — the quota IS the
# tenant's state-tensor rung) and the in-queue quota divisor: a tenant
# may hold at most quota // TENANT_QUEUE_FRAC un-drained rows in the
# shared miss queue before admission clamps (metered, journaled).
TENANT_DEFAULT_QUOTA = 1 << 12
TENANT_QUEUE_FRAC = 4

# Commit-plane per-world slice swapped by _world_ctx (analysis pass
# `tenant` pins this literal against datapath/commit.CommitPlane's fields).
COMMIT_WORLD_FIELDS = ("degraded", "last_error", "lkg_generation", "lkg_at")


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclass
class TenantSpec:
    tid: int
    name: str
    quota: int  # flow-cache slots (pow2; per replica on the mesh)
    aff_quota: int  # affinity slots (pow2)
    queue_quota: int  # max un-drained rows in the shared miss queue


@dataclass
class TenantWorld:
    spec: TenantSpec
    fields: dict  # engine _TENANT_WORLD_FIELDS snapshot
    commit_state: tuple  # COMMIT_WORLD_FIELDS values
    audit_state: tuple = (None, None)  # (plane._golden, plane._state_ref)
    slow_stale: bool = False
    queued: int = 0  # un-drained rows in the shared miss queue
    quota_clamps: int = 0
    rollbacks: int = 0
    reshard_rows: int = 0  # rows migrated across certified resizes
    reshard_vetoes: int = 0  # per-world canary vetoes (world latched)
    steps: int = 0
    packets: int = 0
    rung: tuple = ()
    word_off: int = 0  # window origin on the logical global rule-word axis
    words: int = 0


class TenantRegistry:
    """tid -> TenantWorld, plus the logical global rule-word window map."""

    def __init__(self):
        self.worlds: dict[int, TenantWorld] = {}
        self._next_tid = 1
        self._next_word = 0

    def add(self, world: TenantWorld) -> int:
        tid = self._next_tid
        self._next_tid += 1
        world.spec.tid = tid
        world.word_off = self._next_word
        self._next_word += world.words
        self.worlds[tid] = world
        return tid

    def world(self, tid: int) -> TenantWorld:
        w = self.worlds.get(int(tid))
        if w is None:
            raise KeyError(f"unknown tenant id {tid}")
        return w

    def rungs(self) -> set:
        """Occupied rung signatures — the shared-compile bound."""
        return {w.rung for w in self.worlds.values()}


def _sub_batch(batch, sel: np.ndarray):
    """Lane-subset of a PacketBatch (optional columns preserved)."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        kw[f.name] = None if v is None else np.asarray(v)[sel]
    return type(batch)(**kw)


class TenantedDatapath:
    """Mixin: the multi-tenant serving surface on both engines + mesh.

    Engines list their swappable per-world fields in
    `_TENANT_WORLD_FIELDS` and call `_init_tenancy()` at the end of
    their constructor; everything else — world build, swap, quota
    clamp, drain partitioning, metrics — lives here once."""

    _TENANT_WORLD_FIELDS: tuple = ()
    _tenants: Optional[TenantRegistry] = None
    _active_tenant: Optional[TenantWorld] = None
    _tenant_building = False
    _tenant_maint_cursor = 0
    _tenant_task_registered = False
    _serving = None
    _serving_cfg: dict = {}
    _serving_task_registered = False

    def _init_tenancy(self) -> None:
        self._tenants = TenantRegistry()
        self._tenant_maint_cursor = 0
        self._tenant_task_registered = False
        # Worlds captured in the restart snapshot rebuild NOW — this hook
        # runs at the very end of the engine ctor, the first point where
        # the compile machinery a world rebuild needs exists.
        self._restore_tenant_worlds()

    # -- flight recorder (literal-kind discipline, pass `events`) -----

    def _emit(self, kind: str, **fields) -> None:
        """Flight-recorder shim (the per-plane literal-kind discipline
        analysis pass `events` greps for; engines that define their own
        identical shim shadow this one harmlessly)."""
        emit_into(self, kind, **fields)

    # -- rung padding hooks (consulted by the engines' compile paths) --------

    def _tenant_pad_active(self) -> bool:
        return self._tenant_building or self._active_tenant is not None

    def _pad_cps(self, cps):
        """Phase-capacity rung padding — a no-op on the default world, so
        an untenanted engine compiles bit-identically to a build without
        this plane."""
        if not self._tenant_pad_active():
            return cps
        return pad_compiled_phases(cps)

    def _pad_tables(self, host_drs):
        """Entry-axis rung padding of the HOST ruleset (between to_host
        and device placement) — no-op on the default world."""
        if not self._tenant_pad_active():
            return host_drs
        padded, _caps = pad_ruleset_entries(host_drs)
        return padded

    # -- the world swap ------------------------------------------------------

    def _world_export(self) -> dict:
        return {name: getattr(self, name)
                for name in self._TENANT_WORLD_FIELDS}

    def _world_import(self, fields: dict) -> None:
        for name, val in fields.items():
            setattr(self, name, val)

    @contextmanager
    def _world_ctx(self, tid: int):
        """Swap tenant `tid`'s world in, run the ordinary engine
        machinery, swap it back out (mutations exported to the world).

        Alongside the engine fields the swap covers: the commit plane's
        per-world slice (degraded/LKG — a tenant canary veto must
        degrade only its own world), the audit plane's golden digests,
        and the slow-path staleness flag.  Neutralized while swapped:
        snapshot persistence and realization tracing (default-world
        surfaces; documented residue)."""
        if self._active_tenant is not None:
            raise RuntimeError(
                f"tenant world {self._active_tenant.spec.tid} is already "
                f"active; tenant operations do not nest")
        w = self._tenants.world(tid)
        saved = self._world_export()
        saved_real = self._realization
        saved_pdir = getattr(self, "_persist_dir", None)
        saved_store = getattr(self, "_conf_store", None)
        cp = self._commit
        ap = getattr(self, "_audit", None)
        sp = self._slowpath
        saved_cp = tuple(getattr(cp, n) for n in COMMIT_WORLD_FIELDS)
        saved_ap = None if ap is None else (ap._golden, ap._state_ref)
        saved_stale = None if sp is None else sp.stale
        self._world_import(w.fields)
        self._realization = None
        self._persist_dir = None
        self._conf_store = None
        for n, v in zip(COMMIT_WORLD_FIELDS, w.commit_state):
            setattr(cp, n, v)
        if ap is not None:
            ap._golden, ap._state_ref = w.audit_state
        if sp is not None:
            sp.stale = w.slow_stale
        self._active_tenant = w
        try:
            yield w
        finally:
            w.fields = self._world_export()
            w.commit_state = tuple(
                getattr(cp, n) for n in COMMIT_WORLD_FIELDS)
            if ap is not None:
                w.audit_state = (ap._golden, ap._state_ref)
                ap._golden, ap._state_ref = saved_ap
            if sp is not None:
                w.slow_stale = sp.stale
                sp.stale = saved_stale
            for n, v in zip(COMMIT_WORLD_FIELDS, saved_cp):
                setattr(cp, n, v)
            self._world_import(saved)
            self._realization = saved_real
            self._persist_dir = saved_pdir
            self._conf_store = saved_store
            self._active_tenant = None

    # -- world build ---------------------------------------------------------

    @staticmethod
    def _tenant_check_ps(ps) -> None:
        """The tenant policy-set admission rule, enforced at CREATE and
        at every INSTALL (a later install slipping a toServices rule in
        would compile a svcref lowering against the shared service view
        that no service change could ever recompile)."""
        if ps is not None and any(
                getattr(getattr(r, attr, None), "to_services", None)
                for p in ps.policies for r in p.rules
                for attr in ("from_peer", "to_peer")):
            raise ConfigError(
                "tenant policies may not reference Services (toServices): "
                "the service view is shared across tenants and a later "
                "service change could not recompile the tenant's svcref "
                "lowering")

    def _tenant_init_world(self, spec: TenantSpec, ps: PolicySet) -> None:
        """Engine hook: re-initialize the SWAPPED-OUT engine fields as a
        fresh world for `spec` (the caller restores the saved world in
        its finally).  Each engine implements this with its own compile/
        state machinery."""
        raise NotImplementedError

    def tenant_create(self, name: str, ps: Optional[PolicySet] = None, *,
                      quota: int = TENANT_DEFAULT_QUOTA,
                      aff_quota: Optional[int] = None,
                      queue_quota: Optional[int] = None) -> int:
        """Create an isolated policy world -> tenant id.

        `quota` (pow2) sizes the tenant's private flow cache — its
        structural eviction-isolation boundary and its state-tensor
        rung; `aff_quota` defaults to quota / 4, `queue_quota` (shared
        miss-queue residency clamp) to quota / TENANT_QUEUE_FRAC."""
        if self._tenants is None:
            self._init_tenancy()
        if getattr(self, "_dual_stack", False):
            raise ConfigError(
                "tenant worlds are v4-only (like the async slow path): "
                "construct the engine with dual_stack=False")
        if not _is_pow2(quota):
            raise ConfigError(
                f"tenant quota must be a power of two (the state-tensor "
                f"rung), got {quota}")
        aff_quota = max(4, quota // 4) if aff_quota is None else aff_quota
        if not _is_pow2(aff_quota):
            raise ConfigError(
                f"tenant aff_quota must be a power of two, got {aff_quota}")
        queue_quota = (max(1, quota // TENANT_QUEUE_FRAC)
                       if queue_quota is None else int(queue_quota))
        self._tenant_check_ps(ps)
        spec = TenantSpec(tid=0, name=str(name), quota=int(quota),
                          aff_quota=int(aff_quota), queue_quota=queue_quota)
        world = self._tenant_build_world(spec, ps)
        tid = self._tenants.add(world)
        # A resize in flight adopts the newborn world: its fresh state
        # (zero rows) migrates trivially, but the plane must track it so
        # the cutover flips/certifies it with the rest of the fleet.
        plane = getattr(self, "_reshard", None)
        if plane is not None and hasattr(plane, "note_world_created"):
            plane.note_world_created(tid, world)
        self._emit(
            "tenant-create", tenant=tid, name=spec.name,
            quota=spec.quota, queue_quota=spec.queue_quota,
            words=world.words, word_off=world.word_off)
        self._tenant_register_maintenance()
        # A new world is durable state: snapshot immediately (same
        # write-on-commit discipline as install_bundle; no-op without a
        # persist dir).
        if getattr(self, "_persist_dir", None) is not None:
            self._persist()
        return tid

    def _tenant_build_world(self, spec: TenantSpec, ps) -> TenantWorld:
        """Compile a fresh world for `spec` with the engine's own
        machinery, leaving the active (default) world untouched — shared
        by tenant_create and snapshot restore, whose registry wiring
        differs (fresh tid vs. preserved tid)."""
        saved = self._world_export()
        self._tenant_building = True
        try:
            self._tenant_init_world(spec, ps if ps is not None
                                    else PolicySet())
            if getattr(getattr(self, "_cps", None), "has_svcref", False):
                raise ConfigError(
                    "tenant policies may not reference Services "
                    "(toServices): the service view is shared across "
                    "tenants and a later service change could not "
                    "recompile the tenant's svcref lowering")
            return TenantWorld(
                spec=spec,
                fields=self._world_export(),
                commit_state=(False, "", 0, self._commit._clock()),
                rung=self._tenant_rung_sig(),
                words=self._tenant_words(),
            )
        finally:
            self._tenant_building = False
            self._world_import(saved)

    # -- restart persistence (datapath/persist.py two-slot snapshot) ---------

    def _tenant_snapshot_worlds(self) -> list:
        """Per-tenant INPUT state for the restart snapshot: spec + policy
        set + generation — the compiled tensors and flow-cache state are
        a pure function of the first two and deliberately recompile /
        re-classify on boot, exactly the default world's persisted-unit
        rule.  Meters reset at boot like every other stats counter."""
        from ..dissemination import serde

        if self._tenants is None or not self._tenants.worlds:
            return []
        rows = []
        for tid, w in sorted(self._tenants.worlds.items()):
            row = {
                "tid": int(tid),
                "name": w.spec.name,
                "quota": int(w.spec.quota),
                "affQuota": int(w.spec.aff_quota),
                "queueQuota": int(w.spec.queue_quota),
                "generation": int(w.fields["_gen"]),
                "policySet": serde.encode_policy_set(w.fields["_ps"]),
            }
            # Mesh engines: the world's CERTIFIED topology, so a crash
            # mid-resize restores each world to the generation its own
            # canary certified, not the fleet's (`latched` computed at
            # snapshot time — the restore can't reconstruct the
            # pre-crash fleet topology).
            if "_topo_gen" in w.fields:
                tn = int(w.fields["_n_data"])
                tg = int(w.fields["_topo_gen"])
                fleet = (int(getattr(self, "_n_data", tn)),
                         int(getattr(self, "_topo_gen", tg)))
                row["topoN"] = tn
                row["topoGen"] = tg
                row["latched"] = int((tn, tg) != fleet)
            rows.append(row)
        return rows

    def _restore_tenant_worlds(self) -> None:
        """Rebuild the registry from the snapshot's `tenants` list
        (stashed by PersistableDatapath._init_persist): each world
        recompiles from its persisted policy set with its tid and
        generation preserved — tid because dissemination/admission paths
        address tenants by id across the restart, generation because a
        rolled-back tenant generation could alias a pre-crash cached
        denial (the same monotonicity rule as the default world).  A
        world that fails to rebuild is journaled and skipped: one torn
        tenant must not take the whole engine boot down."""
        raw = getattr(self, "_pending_tenant_restore", None)
        self._pending_tenant_restore = None
        if not raw:
            return
        from ..dissemination import serde

        reg = self._tenants
        for d in sorted(raw, key=lambda e: int(e.get("tid", 0))):
            try:
                tid = int(d["tid"])
                spec = TenantSpec(
                    tid=tid, name=str(d["name"]), quota=int(d["quota"]),
                    aff_quota=int(d["affQuota"]),
                    queue_quota=int(d["queueQuota"]))
                gen = int(d.get("generation", 0))
                ps = serde.decode_policy_set(d["policySet"])
                self._tenant_check_ps(ps)
                world = self._tenant_build_world(spec, ps)
            except Exception as e:
                self._emit(
                    "tenant-rollback", tenant=int(d.get("tid", 0) or 0),
                    error=("restore: " + f"{type(e).__name__}: {e}")[:200])
                continue
            world.fields["_gen"] = gen
            # Topology latch (mesh engines): a world snapshotted as
            # latched restores onto ITS certified generation only when
            # the boot mesh still has that width — otherwise the latch
            # is torn (the certified topology no longer exists) and the
            # world boots fleet-aligned, journaled, never a wrong
            # verdict (its state recompiles from the policy set anyway).
            if int(d.get("latched", 0)):
                tn = int(d.get("topoN", 0))
                tg = int(d.get("topoGen", 0))
                if ("_topo_gen" in world.fields
                        and tn == int(getattr(self, "_n_data", 0))):
                    world.fields["_topo_gen"] = tg
                else:
                    self._emit(
                        "tenant-rollback", tenant=tid,
                        error=(f"restore: torn topology latch "
                               f"(n_data={tn} gen={tg}) — world boots "
                               f"fleet-aligned")[:200])
            world.commit_state = (False, "", gen, self._commit._clock())
            world.word_off = reg._next_word
            reg._next_word += world.words
            reg.worlds[tid] = world
            reg._next_tid = max(reg._next_tid, tid + 1)
            self._emit(
                "tenant-create", tenant=tid, name=spec.name,
                quota=spec.quota, queue_quota=spec.queue_quota,
                words=world.words, word_off=world.word_off, restored=1)
        if reg.worlds:
            self._tenant_register_maintenance()

    def _tenant_rung_sig(self) -> tuple:
        """The shared-compile signature of the (just-built) world: the
        static step meta plus every state/rule tensor shape — exactly
        the jit cache key modulo the shared service/forwarding tables.
        Distinct signatures == compiled-program upper bound."""
        from ..models.pipeline import tree_leaves

        shapes = tuple(tuple(x.shape) for x in tree_leaves(self._drs))
        state_shapes = tuple(tuple(x.shape)
                             for x in tree_leaves(self._state))
        return (self._meta_step, shapes, state_shapes)

    def _tenant_words(self) -> int:
        """The world's window width on the logical global rule-word axis
        (both directions — the windows of one tenant are adjacent)."""
        mm = self._meta.match
        return int(mm.w_in + mm.w_out)

    def _tenant_id(self) -> int:
        return 0 if self._active_tenant is None else \
            self._active_tenant.spec.tid

    # -- serving surface -----------------------------------------------------

    def tenant_step(self, tid: int, batch, now: int, *, valid=None):
        with self._world_ctx(tid) as w:
            w.steps += 1
            w.packets += batch.size
            return self.step(batch, now, valid=valid)

    def step_tenants(self, tenant_ids, batch, now: int):
        """Mixed-tenant batch through the serving batcher: lanes stage
        into per-world rings, force-flush onto the canonical pow2 size
        ladder (padding masked via `valid`, so dispatch shapes — and the
        XLA executable count — are bounded by rungs x ladder, never by
        traffic), then de-interleave lane-exactly back into one
        StepResult (`n_miss` summed once per dispatch)."""
        tids = np.asarray(tenant_ids, np.int64)
        if tids.shape[0] != batch.size:
            raise ValueError(
                f"tenant_ids has {tids.shape[0]} lanes, batch has "
                f"{batch.size}")
        b = self.serving_batcher()
        tickets = np.empty(batch.size, np.int64)
        for tid in np.unique(tids):
            sel = np.nonzero(tids == tid)[0]
            tickets[sel] = b.submit(_sub_batch(batch, sel), now,
                                    tenant=int(tid), shed=False)
        b.flush_all(now)
        return b.collect(tickets)

    # -- serving batcher (canonical-shape admission plane) -------------------

    def _init_serving(self, enabled: bool = False, **cfg) -> None:
        """Engine-ctor hook (after `_init_tenancy`): stash the batcher
        knobs; `serving_batcher=True` materializes the plane eagerly
        (registering its flush task at boot), otherwise it builds
        lazily on first `step_tenants`/`serving_batcher()` — plain
        `step()` never touches it, so the unbatched path stays
        bit-identical with the batcher off."""
        self._serving = None
        self._serving_cfg = {k: v for k, v in cfg.items() if v is not None}
        self._serving_task_registered = False
        if enabled:
            self.serving_batcher()

    def serving_batcher(self):
        if getattr(self, "_serving", None) is None:
            from ..serving.batcher import ServingBatcher

            self._serving = ServingBatcher(
                self, **getattr(self, "_serving_cfg", {}))
            self._serving_register_maintenance()
        return self._serving

    def _serving_register_maintenance(self) -> None:
        if getattr(self, "_serving_task_registered", False):
            return
        sched = getattr(self, "_maintenance", None)
        if sched is None:
            return
        from .maintenance import MaintenanceTask

        sched.register(MaintenanceTask(
            "serving-flush", self._maint_serving, budget=4, priority=3,
            shed_when_degraded=False))
        self._serving_task_registered = True

    def _maint_serving(self, now, budget) -> int:
        s = getattr(self, "_serving", None)
        return 0 if s is None else s.tick_flush(now, budget)

    @property
    def serving_plane(self):
        """The live batcher or None — metrics renderer hook (hist_rows);
        handlers must use `serving_stats()` (snapshot-only)."""
        return getattr(self, "_serving", None)

    def serving_stats(self):
        """Counter/knob snapshot of the serving batcher (None when the
        plane was never materialized) — plain dict, API-safe."""
        s = getattr(self, "_serving", None)
        return None if s is None else s.stats()

    def tenant_install_bundle(self, tid: int, ps=None) -> int:
        """Per-tenant transactional install: the full commit-plane walk
        (compile -> canary -> swap -> settle) inside the tenant's world.
        A canary veto / compile fault rolls back and degrades ONLY this
        tenant (journaled `tenant-rollback`); services must be None —
        the service view is shared, and the same admission rule as
        tenant_create applies (no toServices)."""
        self._tenant_check_ps(ps)
        with self._world_ctx(tid) as w:
            rb0 = self._commit.rollbacks_total
            try:
                gen = self.install_bundle(ps, None)
            except Exception as e:
                if self._commit.rollbacks_total > rb0:
                    w.rollbacks += self._commit.rollbacks_total - rb0
                    self._emit(
                        "tenant-rollback", tenant=int(tid),
                        error=f"{type(e).__name__}: {e}"[:200])
                raise
        # Snapshot AFTER the swap exits (persistence is neutralized
        # inside _world_ctx): the committed tenant bundle reaches disk
        # with the same write-on-commit discipline as the default world.
        if getattr(self, "_persist_dir", None) is not None:
            self._persist()
        return gen

    def tenant_apply_group_delta(self, tid: int, group_name: str,
                                 added_ips, removed_ips) -> int:
        with self._world_ctx(tid) as w:
            rb0 = self._commit.rollbacks_total
            try:
                gen = self.apply_group_delta(group_name, added_ips,
                                             removed_ips)
            except Exception as e:
                if self._commit.rollbacks_total > rb0:
                    w.rollbacks += self._commit.rollbacks_total - rb0
                    self._emit(
                        "tenant-rollback", tenant=int(tid),
                        error=f"{type(e).__name__}: {e}"[:200])
                raise
        # Tenant generations have no per-tenant round journal; the delta
        # bump dirties the shared snapshot so the next checkpoint()
        # persists the new tenant generation (the delta path's documented
        # weaker durability, scoped per tenant).
        if getattr(self, "_persist_dir", None) is not None:
            self._persist_dirty = True
        return gen

    def tenant_trace(self, tid: int, batch, now: int) -> list[dict]:
        with self._world_ctx(tid):
            return self.trace(batch, now)

    def tenant_dump_flows(self, tid: int, now: int) -> list[dict]:
        with self._world_ctx(tid):
            return self.dump_flows(now)

    def tenant_cache_stats(self, tid: int) -> dict:
        with self._world_ctx(tid):
            return self.cache_stats()

    def tenant_commit_stats(self, tid: int) -> dict:
        with self._world_ctx(tid):
            return self.commit_stats()

    def tenant_datapath_stats(self, tid: int):
        with self._world_ctx(tid):
            return self.stats()

    @property
    def tenant_count(self) -> int:
        return 0 if self._tenants is None else len(self._tenants.worlds)

    # -- miss-queue quota clamp (consulted by the engines' admit paths) ------

    def _tenant_admit_mask(self, mask: np.ndarray) -> np.ndarray:
        """Clamp the active tenant's admissions to its in-queue quota.
        Clamped lanes keep their provisional verdict and simply are not
        queued — the flow re-misses and re-admits once the tenant's
        backlog drains (the bounded-queue contract, scoped per tenant).
        Default world: unclamped (the queue capacity itself bounds it)."""
        w = self._active_tenant
        if w is None or not mask.any():
            return mask
        allow = max(0, w.spec.queue_quota - w.queued)
        n = int(mask.sum())
        if n <= allow:
            return mask
        out = np.asarray(mask).copy()
        out[np.nonzero(out)[0][allow:]] = False
        clamped = n - allow
        w.quota_clamps += clamped
        self._emit(
            "tenant-quota-clamp", tenant=w.spec.tid, clamped=int(clamped),
            queued=int(w.queued), quota=int(w.spec.queue_quota))
        return out

    def _tenant_note_admitted(self, admitted: int, dropped: int) -> None:
        w = self._active_tenant
        if w is not None:
            w.queued += int(admitted)

    # -- drain partitioning (consulted by the engines' drain callbacks) ------

    def _tenant_drain_split(self, block: dict) -> Optional[dict]:
        """tid -> sub-block for a popped queue block carrying tenant
        rows; None when the block is default-world only (the fast path —
        zero cost without tenants).  Sub-blocks have their tenant column
        ZEROED so the recursive per-world classify takes the plain
        path."""
        if (self._tenants is None or not self._tenants.worlds
                or "tenant" not in block):
            return None
        t = np.asarray(block["tenant"])
        if not (t != 0).any():
            return None
        out: dict[int, dict] = {}
        for tid in np.unique(t):
            sel = np.nonzero(t == tid)[0]
            sub = {c: np.asarray(v)[sel] for c, v in block.items()}
            sub["tenant"] = np.zeros(sel.size, np.int64)
            out[int(tid)] = sub
        return out

    def _tenant_drain_dispatch(self, split: dict, now: int):
        """Classify each tenant's sub-block in its own world; compose
        any deferred finalizers (overlap mode) into one.  A tenant
        finalizer RE-ENTERS its world at retire time: the engine's
        two-slot staging retires it long after this dispatch's swap has
        exited, and the deferred observation (rule metrics, eviction
        accounting) must land in the world that classified the rows,
        never whichever world is active then (regression-pinned)."""
        fins = []
        for tid, sub in sorted(split.items()):
            if tid == 0:
                fin = self._drain_classify(sub, now)
            else:
                with self._world_ctx(tid) as w:
                    fin = self._drain_classify(sub, now)
                    w.queued = max(0, w.queued - len(sub["src_ip"]))
                if fin is not None:
                    def fin(inner=fin, tid=tid):
                        with self._world_ctx(tid):
                            inner()
            if fin is not None:
                fins.append(fin)
        if not fins:
            return None

        def finalize():
            for f in fins:
                f()
        return finalize

    def _tenant_drain_split_blocks(self, blocks: list) -> Optional[dict]:
        """Mesh twin of _tenant_drain_split: per-REPLICA block lists
        (parallel/meshpath._drain_classify) -> tid -> per-replica
        sub-block list (None where a replica has no rows for that
        tenant); None when default-world only."""
        if self._tenants is None or not self._tenants.worlds:
            return None
        if not any(b is not None and "tenant" in b
                   and (np.asarray(b["tenant"]) != 0).any() for b in blocks):
            return None
        tids = sorted({
            int(t) for b in blocks if b is not None
            for t in np.unique(np.asarray(b["tenant"]))})
        out: dict[int, list] = {}
        for tid in tids:
            subs = []
            for b in blocks:
                if b is None:
                    subs.append(None)
                    continue
                sel = np.nonzero(np.asarray(b["tenant"]) == tid)[0]
                if sel.size == 0:
                    subs.append(None)
                    continue
                sub = {c: np.asarray(v)[sel] for c, v in b.items()}
                sub["tenant"] = np.zeros(sel.size, np.int64)
                subs.append(sub)
            out[tid] = subs
        return out

    def _tenant_drain_dispatch_blocks(self, split: dict, now: int,
                                      chunk) -> None:
        for tid, subs in sorted(split.items()):
            n = sum(len(b["src_ip"]) for b in subs if b is not None)
            if tid == 0:
                self._drain_classify(subs, now, chunk=chunk)
            else:
                with self._world_ctx(tid) as w:
                    self._drain_classify(subs, now, chunk=chunk)
                    w.queued = max(0, w.queued - n)
        return None

    # -- maintenance (one budgeted task, round-robin over worlds) ------------

    def _tenant_register_maintenance(self) -> None:
        if self._tenant_task_registered:
            return
        sched = getattr(self, "_maintenance", None)
        if sched is None:
            return
        from .maintenance import MaintenanceTask

        sched.register(MaintenanceTask(
            "tenant-maintain", self._maint_tenants, budget=1, priority=6,
            shed_when_degraded=True))
        self._tenant_task_registered = True

    def _maint_tenants(self, now: int, budget: int) -> int:
        """One world's fused aging+revalidation pass per granted unit,
        rotating over tenants (each world's cache also ages lazily at
        lookup, so rotation latency is a reclaim-promptness knob, not a
        correctness one)."""
        reg = self._tenants
        if reg is None or not reg.worlds:
            return 0
        tids = sorted(reg.worlds)
        spent = 0
        for _ in range(max(1, min(int(budget), len(tids)))):
            tid = tids[self._tenant_maint_cursor % len(tids)]
            self._tenant_maint_cursor += 1
            with self._world_ctx(tid):
                self._epoch_maintain(now)
                if self._slowpath is not None:
                    self._slowpath.stale = False
            spent += 1
        return spent

    # -- observability -------------------------------------------------------

    def _tenant_occupied(self, fields: dict) -> int:
        """Occupied-row census of a world's SNAPSHOTTED state (engine
        hook; no world swap — see tenant_stats)."""
        raise NotImplementedError

    def tenant_stats(self) -> Optional[dict]:
        """Per-tenant meters for the metrics renderer (None without
        tenant worlds, so the scrape surface only exists where the plane
        does).

        Reads ONLY the stored world snapshots — never _world_ctx: this
        surface is reachable from the apiserver's /metrics handler
        THREAD (the reads hardened against racing the engine
        thread), and a swap there could interleave with the engine's
        own.  For the momentarily-active tenant the snapshot is its
        pre-swap image — ordinary scrape staleness, never a race."""
        if self._tenants is None or not self._tenants.worlds:
            return None
        out: dict[int, dict] = {}
        for tid, w in sorted(self._tenants.worlds.items()):
            fields = w.fields
            evictions = (int(fields["_evictions"])
                         if "_evictions" in fields
                         else int(fields["_oracle"].evictions))
            out[tid] = {
                "name": w.spec.name,
                "generation": int(fields["_gen"]),
                "degraded": int(bool(w.commit_state[0])),
                "quota_slots": int(w.spec.quota),
                "queue_quota": int(w.spec.queue_quota),
                "queued": int(w.queued),
                "occupied": int(self._tenant_occupied(fields)),
                "evictions_total": evictions,
                "quota_clamps_total": int(w.quota_clamps),
                "rollbacks_total": int(w.rollbacks),
                "steps_total": int(w.steps),
                "packets_total": int(w.packets),
                "rule_words": int(w.words),
                "word_off": int(w.word_off),
                "reshard_rows_total": int(w.reshard_rows),
                "reshard_vetoes_total": int(w.reshard_vetoes),
                # Mesh engines only: the world's certified topology and
                # whether it is latched behind the fleet (computed from
                # the snapshot — scrape-thread safe like every field
                # read above).
                "topology_generation": int(fields.get("_topo_gen", 0)),
                "latched": int(
                    "_topo_gen" in fields
                    and ((int(fields["_n_data"]), int(fields["_topo_gen"]))
                         != (int(getattr(self, "_n_data", 0)),
                             int(getattr(self, "_topo_gen", 0))))),
            }
        return out

    def tenant_rungs(self) -> set:
        """Occupied rung signatures (the compile-sharing bound)."""
        return set() if self._tenants is None else self._tenants.rungs()
