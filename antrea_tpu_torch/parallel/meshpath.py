"""MeshDatapath: the datapath engine over a (data x rule) mesh held in one
process (the port of antrea_tpu/parallel/meshpath.py).

The JAX engine is one process over a jax.sharding.Mesh, one device per
shard.  This one holds every shard's tensors on one device (a LocalMesh,
parallel/mesh.py) and serves the same Datapath surface with the same
bits:

  stateful fast path   each data replica owns a private flow cache and
                       affinity table (self._state[d]); a deterministic,
                       direction-symmetric 5-tuple hash (shard_of_tuples)
                       routes every packet to its home replica.  Hash-skew
                       overflow lanes spill to other replicas with no_commit
                       set (never caching foreign) and take a bounded
                       home-routed retry (_spill_retry).
  rule axis            each replica keeps its own copy of every rule shard
                       (a RuleGrid); the shards of a data row step in
                       n_rule threads whose first-match hits meet in an
                       elementwise minimum (run_rule_group), the bits of
                       the JAX engine's lax.pmin.  Each shard steps its own
                       copy of the row's state (self._state[d][r]), so no
                       two threads write one tensor; the copies stay equal.
                       At n_rule = 1 the step still passes a combine (the
                       identity), so the one-pass step runs B3's hits-only
                       variant, as the JAX engine does.
  sharded slow path    one bounded miss queue per data replica
                       (MeshSlowPath); a drain pops one block per replica,
                       classifies them in one dispatch (each replica's
                       chunk its own lane slice) and publishes through one
                       epoch counter: the mesh-wide swap.
  replica-gated commit the canary classifies its probes on every data
                       replica's own table copies -> (D, n) codes; one
                       replica's mismatch vetoes the bundle (datapath/
                       commit.py), and the rollback restores every replica.
  striped audit        the audit cursor runs over the global slot space
                       D * S, striped g -> (replica g % D, local slot
                       g // D); the scrub digests fold the logical view
                       (rule shards joined on the word axis, the state's
                       replicas in order).
  live resize          reshard_begin(n) resizes the data axis under
                       traffic (parallel/reshard.py): budgeted migration
                       to the target ring, a certified cutover (the
                       canary redirected onto the target placement, a
                       migrated-row audit), one epoch swap.
  replica failover     failover=True adds the replica-health task
                       (parallel/failover.py): probe, quarantine and mask,
                       an evacuation shrink, a certified readmission.

Everything else (the commit, audit and maintenance planes, deltas,
persistence, tenancy, metrics) is inherited from the port's TpuflowDatapath.
The v4-only and single-card-knob refusals are the JAX engine's
ConfigErrors, word for word.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..compiler.topology import FWD_TUNNEL
from ..config import ConfigError
from ..datapath.interface import StepResult
from ..datapath.maintenance import MaintenanceTask
from ..datapath.slowpath import ADMIT_DROP, MissQueue, SlowPathEngine
from ..datapath.tpuflow import TpuflowDatapath
from ..models import forwarding as fw
from ..models import pipeline as pl
from ..ops import match as m
from ..ops.match import to_host
from ..observability.telemetry import classify_regime
from ..oracle import hashing
from ..packet import PacketBatch
from ..utils import ip as iputil
from .failover import FailoverPlane
from .mesh import (
    LocalMesh,
    _cols,
    _shard_placement,
    local_mesh,
    place_rule_grid,
    rule_join,
    run_rule_group,
    shard_of_tuples,
)
from .reshard import ReshardPlane, resync_world

# Per-row scalar outputs: each data row's becomes one entry of a (D,)
# vector (the candidate histogram (D, H)), as meshpath.py:171-176.
_COUNTERS = ("n_miss", "n_evict", "n_reclaim", "n_prune_skips",
             "n_prune_fb", "prune_cand_hist",
             "tel_probe_hit", "tel_probe_stale", "tel_probe_miss",
             "tel_dma_hb", "tel_chance_bumps")


def _row_lanes(mesh: LocalMesh, cols) -> list:
    """Global (B,) lane tensors (None stays None) -> each data row's
    contiguous slice, by row."""
    B = next(c for c in cols if c is not None).shape[0]
    C = B // mesh.n_data
    return [[None if c is None else c[d * C:(d + 1) * C] for c in cols]
            for d in range(mesh.n_data)]


def _join_rows(outs: list) -> dict:
    """Each data row's outputs (row order) -> the global outputs: lane
    outputs concatenated to (B,), counters stacked to (D,)."""
    return {k: (torch.stack([o[k] for o in outs]) if k in _COUNTERS
                else torch.cat([o[k] for o in outs])) for k in outs[0]}


def _mesh_step_fn(mesh: LocalMesh, meta: pl.PipelineMeta):
    """The mesh's bare stateful step (meshpath.py:154): the fast path, the
    drains and the synchronous slow path at different metas.
    step(states, grid, dsvc, src_f, dst_f, proto, sport, dport, now, gen,
    valid, no_commit, flags, lens) -> (states, out) over global (B,) lane
    tensors; every data row steps its slice, its rule shards combined."""
    def step(states, grid, dsvc, src_f, dst_f, proto, sport, dport, now,
             gen, valid, no_commit, flags, lens):
        outs = []
        for d, (s, t, p, sp, dp, v, nc, fl, ln) in enumerate(_row_lanes(
                mesh, (src_f, dst_f, proto, sport, dport, valid, no_commit,
                       flags, lens))):
            outs.append(run_rule_group(grid.w0, lambda r, comb: pl.pipeline_step(
                states[d][r], grid.rows[d][r], dsvc, s, t, p, sp, dp, now,
                gen, meta=meta, hit_combine=comb, valid=v, no_commit=nc,
                flags=fl, lens=ln if meta.count_flow_stats else None)[1])[0])
        return states, _join_rows(outs)

    return step


def _mesh_step_full_fn(mesh: LocalMesh, meta: pl.PipelineMeta,
                       has_arp: bool):
    """The mesh's full per-packet walk (meshpath.py:192): forwarding is per
    packet over the shared topology tables, and the rule axis takes part
    only in the classification's combine.  step(states, grid, dsvc, dft,
    src_f, dst_f, proto, sport, dport, in_port, now, gen, flags, arp_op,
    valid, no_commit, lens, prune_excl) -> (states, out)."""
    def step(states, grid, dsvc, dft, src_f, dst_f, proto, sport, dport,
             in_port, now, gen, flags, arp_op, valid, no_commit, lens,
             prune_excl):
        outs = []
        for d, (s, t, p, sp, dp, ip, fl, ar, v, nc, ln, px) in enumerate(
                _row_lanes(mesh, (src_f, dst_f, proto, sport, dport,
                                  in_port, flags, arp_op, valid, no_commit,
                                  lens, prune_excl))):
            outs.append(run_rule_group(grid.w0, lambda r, comb: (
                fw.pipeline_step_full(
                    states[d][r], grid.rows[d][r], dsvc, dft, s, t, p, sp,
                    dp, ip, now, gen, fl, ar if has_arp else None,
                    ln if meta.count_flow_stats else None, meta=meta,
                    hit_combine=comb, valid=v, no_commit=nc,
                    prune_exclude=px)[1]))[0])
        return states, _join_rows(outs)

    return step


def _mesh_canary_fn(mesh: LocalMesh, match_meta, fused: bool):
    """The replica-resolved canary classify (meshpath.py:238): every data
    replica walks the probes on its own table copies.
    fn(grid, src_f, dst_f, proto, dport, delta_n) -> (D, n) codes."""
    def fn(grid, src_f, dst_f, proto, dport, delta_n=0):
        return torch.stack([run_rule_group(grid.w0, lambda r, comb: (
            m.classify_batch(grid.rows[d][r], src_f, dst_f, proto, dport,
                             meta=match_meta, hit_combine=comb, fused=fused,
                             delta_n=delta_n)["code"]))[0]
            for d in range(mesh.n_data)])

    return fn


def _scan_replicas(states, scan) -> list:
    """A whole-table scan (the per-replica scans, meshpath.py:271-290) on
    every rule shard's copy of every replica's state -> each replica's
    counts (its first copy's: the copies are equal)."""
    return [[scan(st) for st in row][0] for row in states]


def _replica_cache_stats(states) -> dict:
    """The flow-cache census summed over the replicas."""
    per = [pl.cache_stats(row[0]) for row in states]
    return {k: sum(int(p[k]) for p in per) for k in per[0]}


class _MeshQueueView:
    """Aggregate read surface over the per-replica miss queues, so the
    shared Datapath plumbing (dump_miss_queue, trace overlay, stats)
    keeps its single-queue contract.  `base` carries the cumulative
    counters of a PREVIOUS queue generation across a reshard cutover
    (the queue set is rebuilt at the new replica width; the meters must
    not reset or double-count the re-route pops)."""

    def __init__(self, queues: list[MissQueue], base: Optional[dict] = None):
        self.queues = queues
        self._base = base or {"admitted_total": 0, "overflows_total": 0,
                              "drained_total": 0}

    @property
    def depth(self) -> int:
        return sum(q.depth for q in self.queues)

    @property
    def capacity(self) -> int:
        return sum(q.capacity for q in self.queues)

    @property
    def admitted_total(self) -> int:
        return self._base["admitted_total"] + sum(
            q.admitted_total for q in self.queues)

    @property
    def overflows_total(self) -> int:
        return self._base["overflows_total"] + sum(
            q.overflows_total for q in self.queues)

    @property
    def drained_total(self) -> int:
        return self._base["drained_total"] + sum(
            q.drained_total for q in self.queues)

    def dump(self) -> list[dict]:
        return [row for q in self.queues for row in q.dump()]

    def contains(self, *tup) -> bool:
        return any(q.contains(*tup) for q in self.queues)


class MeshSlowPath(SlowPathEngine):
    """Per-replica miss queues + mesh-wide epoch swap.

    One engine, D bounded queues (miss_queue_slots is PER REPLICA).  The
    epoch plane stays a single counter: a drain classifies one popped
    block per replica in ONE dispatch and `_publish` bumps that one
    counter — the mesh-wide swap.  Atomicity is by construction: the
    next lookup on ANY replica consumes the state that dispatch
    published, never a mix."""

    def __init__(self, owner, n_data: int, *, capacity: int,
                 admission: str, drain_batch: int,
                 source_rate=None, source_burst=None):
        # capacity=1 seed: the base queue is immediately replaced by the
        # per-replica set below (its buffer would be dead weight).
        super().__init__(owner, capacity=1, admission=admission,
                         drain_batch=drain_batch, source_rate=source_rate,
                         source_burst=source_burst)
        self.n_data = int(n_data)
        self._q_capacity = int(capacity)  # per-replica; resize() reuses it
        self.queues = [MissQueue(capacity) for _ in range(self.n_data)]
        self.queue = _MeshQueueView(self.queues)

    # -- admission: route by home shard --------------------------------------

    def admit(self, cols: dict, miss_mask, now: int, shard=None):
        if shard is None:
            raise ValueError(
                "mesh admission requires the batch's shard assignment "
                "(shard_of_tuples ids)")
        self._seen_now = max(self._seen_now, int(now))
        if self._published_at == 0:
            self._published_at = int(now)
        mask = np.asarray(miss_mask, bool)
        # Per-source rate limiting is replica-independent (the bucket
        # keys on the source prefix, not the home shard): ONE batch-wide
        # pass ahead of the per-replica early-drop ramps, mirroring the
        # single-chip admission order.
        base = mask
        mask = self._source_limit(cols, mask, now)
        if self.deny_sink is not None and mask.sum() < base.sum():
            self.deny_sink(cols, base & ~mask, "source-limit", now)
        # admission="drop": the hash coin is replica-independent — one
        # batch-wide compute, thresholded per replica below (each
        # replica's OWN queue depth drives its early-drop ramp; capacity
        # is per-replica, so is the floor).
        coin = (self._drop_coin(cols, mask.shape[0])
                if self.admission == ADMIT_DROP and mask.any() else None)
        admitted = dropped = 0
        for r in range(self.n_data):
            mr = mask & (np.asarray(shard) == r)
            if not mr.any():
                continue
            mr0 = mr
            mr, _shed = self._early_drop(cols, mr, self.queues[r], coin=coin)
            if self.deny_sink is not None and _shed:
                self.deny_sink(cols, mr0 & ~mr, "early-drop", now)
            if not mr.any():
                continue
            a, d = self.queues[r].admit(cols, mr, self.epoch, int(now))
            admitted += a
            dropped += d
            if d:
                self._emit("queue-overflow", replica=int(r), dropped=int(d),
                           depth=int(self.queues[r].depth), at=int(now))
                if self.deny_sink is not None:
                    over = np.zeros(mr.shape, bool)
                    over[np.nonzero(mr)[0][a:]] = True
                    self.deny_sink(cols, over, "queue-overflow", now)
        return admitted, dropped

    # -- epoch plane: the mesh-wide swap -------------------------------------

    def _publish(self, now: int) -> None:
        self.epoch += 1
        self._published_at = int(now)
        self._seen_now = max(self._seen_now, int(now))
        self._emit("mesh-epoch-swap", epoch=int(self.epoch),
                   replicas=int(self.n_data), at=int(now))

    # -- drain: one block per replica, one dispatch --------------------------

    def begin_drain(self, now: int, n: Optional[int] = None) -> bool:
        if self._inflight is not None:
            raise RuntimeError("a drain batch is already in flight")
        # The popped chunk rides the in-flight record: an explicit n >
        # drain_batch must size the drain dispatch's per-replica lane
        # slices too, or one replica's rows would overflow into the
        # next replica's slice (and its foreign cache).
        chunk = int(n) if n is not None else self.drain_batch
        blocks = [q.pop(chunk) for q in self.queues]
        if all(b is None for b in blocks):
            return False
        self._inflight = (blocks, chunk, self.epoch,
                          int(self.owner.generation))
        self._seen_now = max(self._seen_now, int(now))
        self._emit("drain-begin",
                   n=sum(len(b["src_ip"]) for b in blocks if b is not None),
                   replicas=sum(b is not None for b in blocks),
                   epoch=int(self.epoch), gen=int(self.owner.generation))
        return True

    def finish_drain(self, now: int) -> dict:
        if self._inflight is None:
            raise RuntimeError("no drain batch in flight")
        blocks, chunk, _epoch0, gen0 = self._inflight
        self._inflight = None
        k = sum(len(b["src_ip"]) for b in blocks if b is not None)
        stale = int(self.owner.generation) != gen0
        if stale:
            self.stale_reclassified_total += k
        self.owner._drain_classify(blocks, int(now), chunk=chunk)
        self.drains_total += 1
        self.drain_hist.observe(k)
        self._emit("drain-finish", drained=k,
                   stale_reclassified=k if stale else 0, deferred=0)
        self._publish(now)
        return {"drained": k, "stale_reclassified": k if stale else 0}

    # -- elastic resharding: re-home the queue set ---------------------------

    def resize(self, n_data: int, home_fn, now: int) -> tuple[int, int]:
        """Rebuild the per-replica queue set at a new data-axis width and
        re-home every queued miss under the new topology map (the flip
        half of a reshard cutover) -> (requeued, dropped).  Rows move
        VERBATIM (epoch/enq_ts preserved — these are re-routes, not
        re-admissions, so admitted_total is untouched); the previous
        generation's cumulative meters carry over through the view's
        base.  A shrink can overflow the smaller aggregate capacity:
        overflow rows tail-drop with accounting, the ordinary
        bounded-queue contract (the flow re-admits on its next miss)."""
        base = {"admitted_total": self.queue.admitted_total,
                "overflows_total": self.queue.overflows_total,
                "drained_total": self.queue.drained_total}
        blocks = [q.pop(q.depth) for q in self.queues]
        self.n_data = int(n_data)
        self.queues = [MissQueue(self._q_capacity)
                       for _ in range(self.n_data)]
        self.queue = _MeshQueueView(self.queues, base)
        requeued = dropped = 0
        for b in blocks:
            if b is None:
                continue
            home = np.asarray(home_fn(b))
            for r in range(self.n_data):
                idx = np.nonzero(home == r)[0]
                if idx.size == 0:
                    continue
                t, d = self.queues[r].requeue(b, idx)
                requeued += t
                dropped += d
        if dropped:
            self._emit("queue-overflow", dropped=int(dropped),
                       depth=int(self.queue.depth), at=int(now))
        return requeued, dropped

    def evacuate_replica(self, dead: int, home_fn, now: int
                         ) -> tuple[int, int]:
        """Requeue a quarantined replica's queued misses VERBATIM onto
        the survivor queues (the failover plane's quarantine): same
        re-route-not-re-admission contract as resize(), but the queue
        set itself survives — only the dead replica's rows move, homed
        by the survivor-ring map.  Overflow rows tail-drop with
        accounting (the flow re-admits on its next miss) -> (requeued,
        dropped)."""
        q = self.queues[dead]
        block = q.pop(q.depth)
        if block is None:
            return 0, 0
        home = np.asarray(home_fn(block))
        requeued = dropped = 0
        for r in range(self.n_data):
            if r == dead:
                continue
            idx = np.nonzero(home == r)[0]
            if idx.size == 0:
                continue
            t, d = self.queues[r].requeue(block, idx)
            requeued += t
            dropped += d
        if dropped:
            self._emit("queue-overflow", dropped=int(dropped),
                       depth=int(self.queue.depth), at=int(now))
        return requeued, dropped

    def stats(self) -> dict:
        s = super().stats()
        s["replicas"] = self.n_data
        s["replica_depths"] = [q.depth for q in self.queues]
        return s


class MeshDatapath(TpuflowDatapath):
    """TpuflowDatapath served over a (data x rule) mesh held in one process.

    Same Datapath surface, same planes, same knobs — minus the
    single-chip-only ones (module docstring).  `miss_queue_slots` is
    per-replica; `flow_slots`/`aff_slots` are per-replica table sizes
    (global capacity = D × slots, which is what `cache_stats`/
    `audit_stats` report).  The mesh is `mesh` (a LocalMesh) or n_data x
    n_rule shards on `device` (None: the card; raises without CUDA)."""

    # The mesh engine's per-world swap set: the engine's members plus the
    # topology slice (a world serves at its own width and generation), as
    # meshpath.py:578.
    _TENANT_WORLD_FIELDS = TpuflowDatapath._TENANT_WORLD_FIELDS + (
        "_mesh", "_n_data", "_topo_gen", "_replica_audit_entries",
        "_fo_mask",
    )

    def __init__(self, ps=None, services=None, *, mesh=None, n_data: int = 2,
                 n_rule: int = 1, reshard_budget: int = 256,
                 failover: bool = False, failover_knobs=None, **kw):
        if kw.get("dual_stack"):
            raise ConfigError(
                "the mesh datapath is v4-only (like the async slow path); "
                "dual-stack nodes keep the single-chip engine")
        if kw.get("overlap_commits") or kw.get("autotune_drain"):
            raise ConfigError(
                "overlap_commits/autotune_drain are single-chip knobs: the "
                "mesh drain is already one fused sharded dispatch per "
                "replica set")
        if int(reshard_budget) <= 0:
            raise ConfigError(
                f"reshard_budget must be positive (rows per maintenance "
                f"tick), got {reshard_budget}")
        if mesh is None:
            mesh = local_mesh(n_data, n_rule, kw.get("device"))
        elif kw.get("device") is not None and (
                torch.device(kw["device"]) != mesh.device):
            raise ValueError(f"device {kw['device']} is not the mesh's "
                             f"{mesh.device}")
        kw["device"] = mesh.device
        self._mesh = mesh
        self._n_data = int(mesh.n_data)
        self._n_rule = int(mesh.n_rule)
        self._replica_audit_entries = [0] * self._n_data
        self._spill_lanes_total = 0
        self._spill_retried_total = 0
        # Elastic resharding plane (parallel/reshard.py): the affinity
        # topology generation (0 = the boot dense map; every resized
        # topology elects on the consistent ring), the in-flight plane,
        # and the cumulative meters that outlive individual planes.
        self._reshard_budget = int(reshard_budget)
        self._topo_gen = 0
        self._reshard = None
        self._reshard_canary = None  # (mesh, grid, match_meta, D) redirect
        self._reshard_cutovers = 0
        self._reshard_aborts = 0
        self._reshard_migrated_total = 0
        self._reshard_catchup_total = 0
        self._reshard_requeued_total = 0
        self._reshard_resident_rows = 0
        self._last_reshard_span = None
        self._reshard_tenant_rows_total = 0
        self._reshard_tenant_vetoes = 0
        # Chaos hook (arm_reshard_faults): (FaultPlan, site prefix) for
        # the per-tenant forced-canary-veto sites.
        self._reshard_faults = None
        # Per-world survivor-mask latch (failover.mask_shard's world
        # branch): (dead old-topology index, survivor width, survivor
        # generation).  A WORLD field (_world_ctx swaps it), always None
        # on the default world (the fleet mask covers it).
        self._fo_mask = None
        # Replica-loss failover plane (parallel/failover.py): None when
        # disabled; every traffic-path touch is gated on the field.
        self._failover = None
        super().__init__(ps, services, **kw)
        if failover:
            self._failover = FailoverPlane(self, **(failover_knobs or {}))
            self._maintenance.register(MaintenanceTask(
                "replica-health", self._maint_replica_health,
                budget=max(self._failover.probe_count * self._n_data, 1),
                priority=4, shed_when_degraded=False))

    # -- placement hooks (the whole tensor estate lands on the mesh) ---------

    def _init_pipeline_state(self, flow_slots: int, aff_slots: int):
        """Each data replica's state, one copy per rule shard:
        state[d][r]."""
        return tuple(tuple(pl.init_state(flow_slots, aff_slots,
                                         device=self._device)
                           for _ in range(self._n_rule))
                     for _ in range(self._n_data))

    def _place_rules_on(self, mesh: LocalMesh, cps):
        """Host build at the mesh's word multiple, tenant rung padding,
        then every replica's copy of every rule shard on `mesh` (a
        RuleGrid).  _place_rules calls it at the serving mesh; the reshard
        plane calls it at the TARGET mesh (parallel/reshard.py)."""
        host, meta = to_host(cps, word_multiple=self._n_rule,
                             delta_slots=self._delta_slots,
                             prune_budget=self._prune_budget)
        # The JAX meta's fused_interpret (the Pallas interpret switch of a
        # CPU mesh) has no counterpart: the wrappers pick by device.
        return place_rule_grid(self._pad_tables(host), mesh), meta

    def _place_rules(self, cps):
        return self._place_rules_on(self._mesh, cps)

    def _place_delta(self, dt, n_data: Optional[int] = None):
        """The delta table for every cell of an n_data-row grid (None: the
        serving mesh's) -> cells[d][r]: the per-slot rule masks split on
        the word axis like the incidence they patch (each replica its own
        copy), the ranges replicated."""
        n = self._n_rule

        def cell(r):
            return dt._replace(**{
                f: _cols(getattr(dt, f), n, r).clone()
                for f in ("at_in", "peer_in", "at_out", "peer_out")})

        return tuple(tuple(cell(r) for r in range(n))
                     for _ in range(self._n_data if n_data is None
                                    else int(n_data)))

    def _grid_with_delta(self, grid, dt):
        """A RuleGrid with the delta table dt on every cell."""
        cells = self._place_delta(dt, n_data=len(grid.rows))
        return grid._replace(rows=tuple(
            tuple(drs._replace(ip_delta=cells[d][r])
                  for r, drs in enumerate(row))
            for d, row in enumerate(grid.rows)))

    def _upload_delta_table(self) -> None:
        self._drs = self._grid_with_delta(self._drs, self._build_delta_table())
        self._meta = self._meta._replace(delta_n=self._n_deltas)
        self._meta_step = self._meta_step._replace(delta_n=self._n_deltas)

    def _tenant_rung_sig(self) -> tuple:
        """The world's shared-shape signature (datapath/tenancy.py) over
        every cell of the grid and every copy of the state."""
        cells = [x for row in self._drs.rows for x in row]
        states = [x for row in self._state for x in row]
        return (self._meta_step,
                tuple(tuple(t.shape) for c in cells for t in pl.tree_leaves(c)),
                tuple(tuple(t.shape) for s in states
                      for t in pl.tree_leaves(s)))

    # -- tenancy hooks (datapath/tenancy.TenantedDatapath) -------------------

    def _tenant_init_world(self, spec, ps) -> None:
        super()._tenant_init_world(spec, ps)
        # A fresh world is fleet-aligned (its export carries the live
        # _mesh/_n_data/_topo_gen as-is) but must own its OWN audit-entry
        # list and mask latch — exporting the engine's list object would
        # alias every world's counters to the fleet's.
        self._replica_audit_entries = [0] * int(self._n_data)
        self._fo_mask = None

    def _make_slowpath(self, *, capacity, admission, drain_batch,
                       source_rate=None, source_burst=None,
                       **_single_chip_knobs):
        # autotune/overlap were rejected as ConfigError in __init__, so
        # the ignored kwargs here are always their inert defaults.
        return MeshSlowPath(self, self._n_data, capacity=capacity,
                            admission=admission, drain_batch=drain_batch,
                            source_rate=source_rate,
                            source_burst=source_burst)

    # -- unsupported single-chip surfaces ------------------------------------

    def profile(self, batch, fresh=None, **kw) -> dict:
        raise NotImplementedError(
            "profile() is a single-chip surface; the multichip regime is "
            "measured by bench.py's multichip section")

    # -- the sharded step ----------------------------------------------------

    def _step(self, batch: PacketBatch, now: int, valid=None) -> StepResult:
        D = self._n_data
        B = batch.size
        if B % D:
            raise ValueError(
                f"batch size {B} is not divisible by the data-axis size {D}")
        # Serving-batcher padding mask (canonical sizes are pow2 >= D, so
        # divisibility holds): padded lanes join the kernel's per-lane
        # validity in PERMUTED order and are excluded from the home-routed
        # spill retry below — a padding lane never caches anywhere.
        ext = None if valid is None else np.asarray(valid, bool)
        self._v6_lanes(batch)  # v4-only guard (dual_stack is always False)
        lens = np.maximum(batch.lens(), 0)
        flags = np.asarray(batch.flags()).astype(np.int32)
        in_ports = np.asarray(batch.in_ports()).astype(np.int32)
        has_arp = batch.arp_op is not None
        arp = (np.asarray(batch.arp_ops()).astype(np.int32) if has_arp
               else np.zeros(B, np.int32))
        shard = shard_of_tuples(batch.src_ip, batch.dst_ip, batch.proto,
                                batch.src_port, batch.dst_port, D,
                                self._topo_gen, tenant=self._tenant_id())
        # Replica-loss failover (parallel/failover.py): lanes homed on a
        # quarantined replica re-home host-side onto the survivor ring.
        fo = self._failover
        fo_masked = None
        if fo is not None:
            shard, fo_masked = fo.mask_shard(
                batch.src_ip, batch.dst_ip, batch.proto, batch.src_port,
                batch.dst_port, shard, tenant=self._tenant_id())
        perm, inv, spill = _shard_placement(shard, D)
        # The walk derives the mcast/teardown commit gating and the
        # SpoofGuard/ARP/IGMP validity masks itself (models/forwarding);
        # the engine contributes only the spill rule — an off-home lane
        # classifies but never caches in a foreign replica.
        stepf = _mesh_step_full_fn(self._mesh, self._meta_step, has_arp)
        spill_t = self._lane(spill, bool)
        t0 = time.perf_counter() if fo is not None else 0.0
        state, out = stepf(
            self._state, self._drs, self._dsvc, self._dft,
            self._flipped(batch.src_ip[perm]),
            self._flipped(batch.dst_ip[perm]), self._lane(batch.proto[perm]),
            self._lane(batch.src_port[perm]),
            self._lane(batch.dst_port[perm]), self._lane(in_ports[perm]),
            int(now), int(self._gen), self._lane(flags[perm]),
            self._lane(arp[perm]) if has_arp else None,
            self._lane(np.ones(B, bool) if ext is None else ext[perm], bool),
            spill_t, self._lane(lens[perm]) if self._flow_stats else None,
            spill_t,
        )
        self._state = state
        self._state_mutations += 1
        o = self._to_host(out)
        if fo is not None:
            # Dispatch-liveness deadline: a stalled dispatch (the read-back
            # above waits for it) is a wedge symptom.
            fo.note_dispatch(time.perf_counter() - t0, now)
        o.pop("n_miss")
        self._evictions += int(o.pop("n_evict").sum())
        self._reclaims += int(o.pop("n_reclaim").sum())
        # Spilled lanes are EXCLUDED from this dispatch's prune evidence
        # (prune_exclude=spill above): their foreign-replica walk is not
        # the serving walk, and the home-routed retry below accounts them
        # instead — each lane feeds the PruneAutotuner band exactly once,
        # from the walk production actually serves.
        self._prune_account(o)
        for k in ("n_prune_skips", "n_prune_fb", "prune_cand_hist"):
            o.pop(k, None)
        # Telemetry counters ride (D,) per-replica — pop them before the
        # per-LANE reindex below.  Spilled lanes are excluded from this
        # dispatch's counters too (the same mask): the retry meters them.
        tel_o = {k: o.pop(k) for k in tuple(o) if k.startswith("tel_")}
        o = {k: v[inv] for k, v in o.items()}  # back to packet order
        spilled = perm[np.nonzero(
            spill if ext is None else spill & ext[perm])[0]]  # off-home
        if spilled.size:
            o = self._spill_retry(batch, o, spilled, shard, flags, in_ports,
                                  arp, has_arp, lens, now)
        # Recomputed from the MERGED per-lane mask: a retried lane's miss
        # image is its home-replica one, not the foreign always-miss.
        n_miss = int(o["miss"].sum())
        if fo_masked is not None:
            # The evacuation re-miss burst: dead-resident flows pay one
            # re-miss each on their survivor home (bounded, metered).
            fo.note_remiss(np.count_nonzero((o["miss"] != 0)[fo_masked]))
        # Dirty-row tracking for an in-flight resize (parallel/reshard.py):
        # every lane's home (replica, slot) may be refreshed, committed or
        # torn down by this step after its migration window; record it so
        # the cutover catch-up sweeps the touched set, not every slot.
        if self._reshard is not None:
            self._note_reshard_touched(
                shard, batch.src_ip, batch.dst_ip, batch.proto,
                batch.src_port, batch.dst_port,
                committed=o.get("committed"), dnat_f=o.get("dnat_ip_f"),
                dnat_port=o.get("dnat_port"))
        pending = None
        if self._async:
            pending = o["miss"]
            # Route each admitted miss to its HOME replica's queue — a
            # spilled lane's drain then classifies and commits it on the
            # replica that owns it.  Tenant worlds: quota-clamped admission
            # + the tenant id column (datapath/tenancy — no-ops on the
            # default world).  The queue set is SHARED at the fleet width:
            # a world at another width clamps onto the fleet's queues (the
            # queue index is transport only; the drain re-splits per
            # tenant and re-lays rows out on the world's own topology).
            sp_n = self._slowpath.n_data
            admitted, _dropped = self._slowpath.admit(
                self._queue_cols(batch, batch.flags(), lens,
                                 tenant=self._tenant_id()),
                self._tenant_admit_mask(pending != 0), now,
                shard=shard if sp_n == D else shard % sp_n)
            self._tenant_note_admitted(admitted, _dropped)
        if self._telemetry is not None:
            # Engine/tenant scopes classify from the MERGED per-lane miss
            # image (a retried lane's miss is its home-replica one); each
            # replica additionally classifies from its own home lanes, so
            # a single cold replica reads cold even when the mesh-wide
            # regime is steady.
            self._telemetry_account({**tel_o, "n_miss": n_miss}, B)
            miss_rep = np.bincount(shard[o["miss"] != 0], minlength=D)
            cnt_rep = np.bincount(shard, minlength=D)
            for d in range(D):
                self._telemetry.note_regime(
                    f"replica{d}",
                    classify_regime(int(cnt_rep[d]), int(miss_rep[d])))
        in_ids = self._cps.ingress.rule_ids
        out_ids = self._cps.egress.rule_ids
        self._count_metrics(o, in_ids, out_ids, lens, pending=pending)
        if self._deny is not None:
            self._deny_verdicts(batch, o["code"], pending, now)
        unflip = iputil.unflip_u32_array
        return StepResult(
            code=o["code"],
            est=o["est"],
            pending=pending,
            reply=o["reply"],
            reject_kind=o["reject_kind"],
            snat=o["snat"],
            dsr=o["dsr"],
            svc_idx=o["svc_idx"],
            dnat_ip=unflip(o["dnat_ip_f"]),
            dnat_port=o["dnat_port"],
            ingress_rule=self._rule_ids_in(in_ids, o["ingress_rule"]),
            egress_rule=self._rule_ids_out(out_ids, o["egress_rule"]),
            committed=o["committed"],
            n_miss=n_miss,
            spoofed=o["spoofed"],
            punt=o["punt"],
            mcast_idx=o["mcast_idx"],
            l7_redirect=o["l7_redirect"],
            fwd_kind=o["fwd_kind"],
            out_port=o["out_port"],
            # peer_f is zeroed for non-deliverable lanes in the walk; the
            # (kind==TUNNEL & deliverable) gate avoids un-flipping that 0.
            peer_ip=np.where(
                (o["fwd_kind"] == FWD_TUNNEL) & (o["out_port"] != -1),
                unflip(o["peer_f"]), 0,
            ).astype(np.uint32),
            dec_ttl=o["dec_ttl"],
            tc_act=o["tc_act"],
            tc_port=o["tc_port"],
        )

    def _spill_retry(self, batch: PacketBatch, o: dict, spilled: np.ndarray,
                     shard: np.ndarray, flags: np.ndarray,
                     in_ports: np.ndarray, arp: np.ndarray, has_arp: bool,
                     lens: np.ndarray, now: int) -> dict:
        """Second, bounded, HOME-ROUTED dispatch for hash-skew overflow.

        Spilled lanes' main-dispatch image is a foreign-replica walk: they
        can never see their home cache entry, so without this pass an
        established flow caught in skew would serve provisional verdicts
        forever (fatal under admission="hold": true-ALLOW traffic reads
        as DROP).  Here each replica gets ITS OWN spilled lanes — home
        placement by construction — padded to a power-of-two rung so the
        shape count stays O(log(B/D)).  Per-replica overflow beyond one
        full home slice (B/D lanes; the all-flows-one-replica pathology)
        keeps the provisional-spill semantics rather than cascading
        dispatches.  Merges the retried lanes' outputs into `o` (packet
        order) and returns it."""
        D = self._n_data
        C = batch.size // D
        by_shard = [spilled[shard[spilled] == r] for r in range(D)]
        m = max(x.size for x in by_shard)
        rung = min(C, max(16, 1 << (m - 1).bit_length()))
        take = [x[:rung] for x in by_shard]
        Bm = D * rung
        idx = np.zeros(Bm, np.int64)
        valid = np.zeros(Bm, bool)
        for r, x in enumerate(take):
            idx[r * rung:r * rung + x.size] = x
            valid[r * rung:r * rung + x.size] = True
        stepf = _mesh_step_full_fn(self._mesh, self._meta_step, has_arp)
        state, out = stepf(
            self._state, self._drs, self._dsvc, self._dft,
            self._flipped(batch.src_ip[idx]), self._flipped(batch.dst_ip[idx]),
            self._lane(batch.proto[idx]), self._lane(batch.src_port[idx]),
            self._lane(batch.dst_port[idx]), self._lane(in_ports[idx]),
            int(now), int(self._gen), self._lane(flags[idx]),
            self._lane(arp[idx]) if has_arp else None,
            self._lane(valid, bool), self._lane(np.zeros(Bm, bool), bool),
            self._lane(lens[idx]) if self._flow_stats else None,
            self._lane(~valid, bool),
        )
        self._state = state
        self._state_mutations += 1
        o2 = self._to_host(out)
        self._evictions += int(o2.pop("n_evict").sum())
        self._reclaims += int(o2.pop("n_reclaim").sum())
        o2.pop("n_miss")
        # The retry owns the retried lanes' prune evidence (the main
        # dispatch excluded them via prune_exclude=spill): each lane is
        # metered exactly once, from its HOME (serving) walk.  Padding
        # lanes are excluded via prune_exclude=~valid above.
        self._prune_account(o2)
        for k in ("n_prune_skips", "n_prune_fb", "prune_cand_hist"):
            o2.pop(k, None)
        if self._telemetry is not None:
            # The retry owns the retried lanes' PROBE counters too (the
            # main dispatch masked them out, same as the prune evidence);
            # padding lanes ride excluded via prune_exclude=~valid.
            self._telemetry.account(o2)
        sel = np.nonzero(valid)[0]
        pkts = idx[sel]
        for k in o:
            o[k][pkts] = o2[k][sel]
        self._spill_lanes_total += int(spilled.size)
        self._spill_retried_total += int(sel.size)
        return o

    # -- sharded slow-path callbacks -----------------------------------------

    def _drain_classify(self, blocks: list, now: int,
                        chunk: Optional[int] = None):
        """Classify one popped block PER REPLICA in a single drain
        dispatch (each replica's chunk is its slice of the batch axis) and
        publish the new per-replica cache state — the commit half of the
        mesh-wide epoch swap.  Padding lanes ride masked out via `valid`;
        all lanes are home lanes (admission routed them), so there is no
        spill term here.  `chunk` is the pop size the engine pinned at
        begin_drain (an explicit begin_drain(n) may exceed drain_batch;
        each replica's lane slice must be that wide).

        Tenant rows (datapath/tenancy): blocks carrying tenant ids
        partition per tenant and each tenant's per-replica sub-blocks
        classify inside its world — zero cost without tenant worlds."""
        split = self._tenant_drain_split_blocks(blocks)
        if split is not None:
            return self._tenant_drain_dispatch_blocks(split, now, chunk)
        t0 = time.perf_counter()
        sp = self._slowpath
        chunk = int(chunk) if chunk is not None else sp.drain_batch
        D = self._n_data
        Bd = D * chunk
        valid = np.zeros(Bd, bool)

        def col(name, dtype=np.int32):
            out = np.zeros(Bd, dtype)
            for r, b in enumerate(blocks):
                if b is None:
                    continue
                k = len(b["src_ip"])
                out[r * chunk:r * chunk + k] = (
                    np.asarray(b[name])[:k].astype(dtype))
            return out

        for r, b in enumerate(blocks):
            if b is not None:
                valid[r * chunk:r * chunk + len(b["src_ip"])] = True
        src = col("src_ip", np.uint32)
        dst = col("dst_ip", np.uint32)
        proto = col("proto")
        sport = col("src_port")
        dport = col("dst_port")
        flags = col("flags")
        lens = np.maximum(col("lens"), 0)
        no_commit = pl.no_commit_mask(dst, proto, flags)
        drainf = _mesh_step_fn(self._mesh, self._drain_meta(chunk))
        state, out = drainf(
            self._state, self._drs, self._dsvc,
            self._flipped(src), self._flipped(dst), self._lane(proto),
            self._lane(sport), self._lane(dport), int(now), int(self._gen),
            self._lane(valid, bool), self._lane(no_commit, bool),
            self._lane(flags), self._lane(lens) if self._flow_stats else None,
        )
        self._state = state
        self._state_mutations += 1
        o = self._to_host(out)
        self._evictions += int(o["n_evict"].sum())
        self._reclaims += int(o["n_reclaim"].sum())
        self._prune_account(o)
        in_ids = self._cps.ingress.rule_ids
        out_ids = self._cps.egress.rule_ids
        sel = valid
        self._count_metrics(
            {k: o[k][sel] for k in ("code", "ingress_rule", "egress_rule")},
            in_ids, out_ids, lens[sel],
        )
        if self._telemetry is not None:
            # One dispatch drains every replica at once: fold its counters
            # and its wall seconds into the engine's "drain" regime (never
            # deferred here — overlap staging is single-chip).
            self._telemetry.account(o)
            self._telemetry.observe_scoped(
                "engine", "drain", time.perf_counter() - t0)
        # Dirty-row tracking for an in-flight resize.
        if self._reshard is not None:
            replica = (np.arange(Bd) // chunk).astype(np.int32)
            self._note_reshard_touched(
                replica[valid], src[valid], dst[valid], proto[valid],
                sport[valid], dport[valid],
                committed=o["committed"][valid],
                dnat_f=o["dnat_ip_f"][valid],
                dnat_port=o["dnat_port"][valid])
        return None  # never deferred: overlap staging is single-chip

    def _epoch_maintain(self, now: int) -> tuple[int, int]:
        n = _scan_replicas(self._state, lambda st: pl._maintain_scan(
            st, int(now), int(self._gen), timeouts=self._meta.timeouts)[1:])
        self._state_mutations += 1
        return sum(int(a) for a, _ in n), sum(int(b) for _, b in n)

    def _epoch_revalidate(self) -> int:
        n = _scan_replicas(self._state, lambda st: pl._revalidate_scan(
            st, int(self._gen))[1])
        self._state_mutations += 1
        return sum(int(x) for x in n)

    def _epoch_age_scan(self, now: int) -> int:
        n = _scan_replicas(self._state, lambda st: pl._age_scan(
            st, int(now), timeouts=self._meta.timeouts)[1])
        self._state_mutations += 1
        return sum(int(x) for x in n)

    # -- commit plane hooks --------------------------------------------------

    def _remap_cached_attribution(self, old_in: list, old_out: list) -> None:
        """The attribution remap on every replica's state copies, each
        written as a new flow-meta tensor (the commit snapshot keeps the
        old ones)."""
        # Same ids in the same order is the remap's no-op (services-only
        # bundles, degraded-recovery recompiles): no cache row rewritten,
        # so the bounded dirty set of an in-flight resize must survive.
        changed = (list(old_in) != list(self._cps.ingress.rule_ids)
                   or list(old_out) != list(self._cps.egress.rule_ids))
        remap = self._attribution_remap(old_in, old_out)
        if remap is not None:
            self._state = tuple(
                tuple(st._replace(flow=st.flow._replace(
                    meta=self._remapped_meta(st.flow.meta, remap)))
                    for st in row) for row in self._state)
            self._state_mutations += 1
        # A mid-resize bundle that REALLY remapped attribution touched the
        # whole cache: no bounded dirty set covers that, so the catch-up
        # falls back to the full sweep (for the world that remapped).
        if changed and self._reshard is not None:
            self._reshard.note_all_dirty(tenant=self._tenant_id())

    def _canary_classify(self, batch: PacketBatch, now: int) -> np.ndarray:
        """REPLICA-RESOLVED fresh-walk verdicts: each data replica walks
        the probe set on its own copies of the rule tables -> (D, n)
        codes.  datapath/commit.py diffs every row against the Oracle; any
        replica's mismatch vetoes the bundle for the whole mesh (the
        rollback restores every replica)."""
        del now  # probes are stateless fresh walks
        # A reshard plane certifying its TARGET topology redirects the probe
        # walk onto the target placement (parallel/reshard.py sets
        # _reshard_canary around the commit plane's _canary call): the
        # same replica-resolved diff and veto then gate the cutover.
        tgt = self._reshard_canary
        if tgt is None:
            mesh, grid, mm = self._mesh, self._drs, self._meta.match
        else:
            mesh, grid, mm, _n = tgt
        fn = _mesh_canary_fn(mesh, mm, self._meta.fused)
        got = fn(grid, self._flipped(batch.src_ip),
                 self._flipped(batch.dst_ip), self._lane(batch.proto),
                 self._lane(batch.dst_port), delta_n=self._meta.delta_n)
        return got.cpu().numpy()

    # -- audit plane hooks (striped cursor + per-replica state) --------------

    def _audit_rule_digests(self) -> dict:
        """Checksum digests over the LOGICAL view of each tensor group
        (meshpath.py:1156): the rule shards joined on the word axis (data
        replica 0's copies: per-replica divergence of a replicated table is
        the replica-resolved canary's to catch), the shared service and
        forwarding tables."""
        row = self._drs.rows[0]
        drs = row[0] if len(row) == 1 else rule_join(row)
        return {
            "drs": pl.tensor_digest(pl.tree_leaves(drs)),
            "dsvc": pl.tensor_digest(pl.tree_leaves(self._dsvc)),
            "dft": pl.tensor_digest(pl.tree_leaves(self._dft)),
        }

    def _audit_state_digest(self) -> int:
        """The state's logical view: each leaf over the replicas in order,
        as the JAX engine's (D, ...) arrays."""
        per = [pl.tree_leaves(row[0]) for row in self._state]
        return pl.tensor_digest(
            torch.cat([leaf.reshape(-1) for leaf in leaves])
            for leaves in zip(*per))

    def _audit_slots(self) -> int:
        return self._n_data * self._meta.flow_slots

    def _audit_window(self, cursor: int, k: int, now: int) -> list[dict]:
        """Striped window over the GLOBAL slot space: global slot g lives
        at (replica g % D, local slot g // D), so one budgeted window
        advances audit coverage on every replica simultaneously and
        `audit_cursor_coverage_ratio` keeps its meaning fleet-wide."""
        D, S = self._n_data, self._meta.flow_slots
        G = D * S
        cursor %= G
        rows: list[dict] = []
        for r in range(D):
            first = cursor + ((r - cursor) % D)
            if first >= cursor + k:
                continue
            count = (cursor + k - first + D - 1) // D
            local_start = first // D
            keys_d, meta_d, ts_d = pl.audit_gather(
                self._state[r][0], local_start % S, window=count)
            got = self._decode_audit_rows(
                keys_d, meta_d, ts_d, now,
                lambda i, r=r, ls=local_start: (((ls + i) % S) * D + r))
            self._replica_audit_entries[r] += len(got)
            rows.extend(got)
        rows.sort(key=lambda e: (e["slot"] - cursor) % G)
        return rows

    def _audit_fresh(self, rows: list, now: int) -> list[dict]:
        """Fresh-walk re-proof per HOME replica: each audited row is
        re-proved against its owning replica's state and table copies
        (the affinity view that classified it)."""
        by_replica: dict[int, list[int]] = {}
        for i, e in enumerate(rows):
            by_replica.setdefault(e["slot"] % self._n_data, []).append(i)
        out: list = [None] * len(rows)
        for r, idxs in sorted(by_replica.items()):
            got = self._audit_fresh_state(r, [rows[i] for i in idxs], now)
            for i, rec in zip(idxs, got):
                out[i] = rec
        return out

    def _trace_out(self, state, batch: PacketBatch, now: int) -> dict:
        """pipeline_trace of a batch on one data replica -> numpy outputs
        (state untouched).  On the mesh the replica's index stands for the
        state: the walk reads that replica's state and rule copies, its
        rule shards combined.  An explicit PipelineState (the reshard
        plane's migrated tables) is walked against data replica 0's rule
        copies, every rule shard reading it."""
        if isinstance(state, pl.PipelineState):
            d, states = 0, [state] * self._n_rule
        else:
            d = int(state)
            states = self._state[d]
        cols = (self._flipped(batch.src_ip), self._flipped(batch.dst_ip),
                self._lane(batch.proto), self._lane(batch.src_port),
                self._lane(batch.dst_port))
        o = run_rule_group(self._drs.w0, lambda r, comb: pl.pipeline_trace(
            states[r], self._drs.rows[d][r], self._dsvc, *cols,
            int(now), int(self._gen), meta=self._meta, hit_combine=comb))[0]
        return self._to_host(o)

    def _audit_evict(self, slots: list) -> None:
        D = self._n_data
        groups: dict[int, list[int]] = {}
        for g in slots:
            groups.setdefault(int(g) % D, []).append(int(g) // D)
        for r, ls in sorted(groups.items()):
            local = torch.tensor(ls, dtype=torch.int32, device=self._device)
            for st in self._state[r]:
                pl.audit_evict(st, local)
        self._state_mutations += 1

    def _audit_corrupt(self, kind: str, now: Optional[int] = None) -> str:
        if kind == "tensor":
            if int(self._dsvc.ep_port.shape[0]) > 0:
                return super()._audit_corrupt(kind, now)
            # No services: one delta-table word, on every cell (the JAX
            # engine's replicated array).
            self._drs = self._drs._replace(rows=tuple(
                tuple(c._replace(ip_delta=c.ip_delta._replace(
                    lo_f=_flip_first(c.ip_delta.lo_f))) for c in row)
                for row in self._drs.rows))
            return "flipped drs.ip_delta.lo_f[0] bit 0"
        # Verdict-bit flip on ONE replica's private state — real
        # replica-local corruption only the striped audit cursor can see.
        D = self._n_data
        _, M1C, _, _ = pl._meta_cols(self._meta.key_words - 2)
        for r in range(D):
            flow = self._state[r][0].flow
            keys = flow.keys[:-1].cpu().numpy().astype(np.int64)
            if now is not None:
                meta_np = flow.meta[:-1].cpu().numpy().astype(np.int64)
                ts_np = flow.ts[:-1].cpu().numpy()
                live, _egen = self._live_mask(keys, meta_np, ts_np, now)
            else:
                kpg = keys[:, -1]
                gen_w = self._gen % pl.GEN_ETERNAL
                egen = (kpg >> 9) & pl.GEN_ETERNAL
                live = (kpg != 0) & ((egen == pl.GEN_ETERNAL)
                                     | (egen == gen_w))
            idx = np.nonzero(live)[0]
            if idx.size == 0:
                continue
            slot = int(idx[0])
            for st in self._state[r]:
                st.flow.meta[slot, M1C] ^= 1
            return (f"flipped cached verdict bit of replica {r} "
                    f"slot {slot}")
        return self._audit_corrupt("tensor")

    def corrupt_replica(self, replica: int) -> str:
        """Chaos helper: flip the rule-side table copies held by ONE data
        replica — real divergence of a logically replicated tensor (the
        bit-flip-on-one-device model).  The next replica-resolved canary
        (install gate or watchdog) diverges on exactly this replica and
        vetoes, rolling back / degrading the WHOLE mesh; recovery is the
        ordinary canary-gated recompile, whose fresh placement rebuilds
        every copy from the host mirror.  The mutation counter is
        deliberately not bumped — silent corruption is the thing being
        modeled."""
        self._drs = self._flip_replica_rules(self._drs, int(replica))
        return (f"flipped rule-side device copies held by data replica "
                f"{replica}")

    @staticmethod
    def _flip_replica_rules(grid, replica: int):
        """A RuleGrid with bit 0 of the actions and isolation values of
        data replica `replica`'s copies flipped (every rule shard), new
        tensors; the other replicas' copies untouched."""
        def flip(drs):
            return drs._replace(
                ingress=drs.ingress._replace(action=drs.ingress.action ^ 1),
                egress=drs.egress._replace(action=drs.egress.action ^ 1),
                iso_in=drs.iso_in._replace(val=drs.iso_in.val ^ 1),
                iso_out=drs.iso_out._replace(val=drs.iso_out.val ^ 1))

        return grid._replace(rows=tuple(
            tuple(flip(c) for c in row) if d == replica else row
            for d, row in enumerate(grid.rows)))

    # -- host-side observability over the (D,) axis --------------------------

    def dump_flows(self, now: int) -> list[dict]:
        return [e for row in self._state
                for e in self._dump_flows_state(row[0], now)]

    def cache_stats(self) -> dict:
        c = _replica_cache_stats(self._state)
        c["evictions"] = self._evictions
        c["reclaims"] = self._reclaims
        return c

    def _tenant_occupied(self, fields: dict) -> int:
        """Snapshot-state occupancy summed over the replicas (tenancy
        tenant_stats — the scrape path must never swap worlds)."""
        return _replica_cache_stats(fields["_state"])["occupied"]

    def _tenant_drain_dispatch_blocks(self, split: dict, now: int,
                                      chunk) -> None:
        """Mesh override of the per-tenant drain dispatch: a world at
        another width or topology generation than the fleet's serves on
        its own topology, so its rows re-split onto it before its drain
        classifies (homes are re-derived from the tuple columns the rows
        carry verbatim)."""
        fleet = (self._n_data, self._topo_gen)
        for tid, subs in sorted(split.items()):
            n = sum(len(b["src_ip"]) for b in subs if b is not None)
            if tid == 0:
                self._drain_classify(subs, now, chunk=chunk)
                continue
            with self._world_ctx(tid) as w:
                if (self._n_data, self._topo_gen) != fleet:
                    wsubs, chunk_w = self._relayout_world_blocks(subs)
                    self._drain_classify(wsubs, now, chunk=chunk_w)
                else:
                    self._drain_classify(subs, now, chunk=chunk)
                w.queued = max(0, w.queued - n)
        return None

    def _relayout_world_blocks(self, subs: list):
        """Concatenate a world's per-replica sub-blocks and re-split them
        by the world's OWN affinity topology (the tenant-salted map at the
        world's width/generation, the world's survivor mask applied) ->
        (blocks, chunk).  Runs inside the world's ctx.  The chunk is
        pow2-rounded from the max per-replica count, the spill retry's
        rung discipline."""
        rows = [b for b in subs if b is not None]
        block = {c: np.concatenate([np.asarray(b[c]) for b in rows])
                 for c in rows[0]}
        cols = (block["src_ip"].astype(np.uint32),
                block["dst_ip"].astype(np.uint32),
                block["proto"].astype(np.int32),
                block["src_port"].astype(np.int32),
                block["dst_port"].astype(np.int32))
        home = shard_of_tuples(*cols, self._n_data, self._topo_gen,
                               tenant=self._tenant_id())
        if self._failover is not None:
            home, _m = self._failover.mask_shard(
                *cols, home, tenant=self._tenant_id())
        out = []
        mx = 1
        for r in range(self._n_data):
            idx = np.nonzero(home == r)[0]
            if idx.size == 0:
                out.append(None)
                continue
            out.append({c: v[idx] for c, v in block.items()})
            mx = max(mx, int(idx.size))
        chunk = 1 << max(4, (mx - 1).bit_length())
        return out, chunk

    def trace(self, batch: PacketBatch, now: int) -> list[dict]:
        if not self._gates.enabled("Traceflow"):
            raise RuntimeError("Traceflow feature gate is disabled")
        D = self._n_data
        shard = shard_of_tuples(batch.src_ip, batch.dst_ip, batch.proto,
                                batch.src_port, batch.dst_port, D,
                                self._topo_gen, tenant=self._tenant_id())
        if self._failover is not None:
            # Trace what serving serves: quarantined-home lanes re-home
            # onto the survivor ring exactly like _step.
            shard, _m = self._failover.mask_shard(
                batch.src_ip, batch.dst_ip, batch.proto, batch.src_port,
                batch.dst_port, shard, tenant=self._tenant_id())
        out: list = [None] * batch.size
        for r in range(D):
            idx = np.nonzero(shard == r)[0]
            if idx.size == 0:
                continue
            sub = PacketBatch.from_packets(
                [batch.packet(int(i)) for i in idx])
            for i, rec in zip(idx, self._trace_batch(r, sub, now)):
                out[int(i)] = rec
        return out

    def mesh_stats(self) -> dict:
        """Shard-labeled observability (rendered as the replica-labeled
        metric families in observability/metrics.py): per-replica
        miss-queue depth, replica-resolved canary mismatches, and
        audited-entry volume under the striped cursor."""
        cp = self._commit
        depths = ([q.depth for q in self._slowpath.queues]
                  if self._slowpath is not None else [0] * self._n_data)
        return {
            "mesh": {"data": self._n_data, "rule": self._n_rule},
            "devices": self._n_data * self._n_rule,
            # Hash-skew pressure: lanes placed off-home, and how many of
            # them the bounded home-routed retry dispatch re-served
            # (equal counters = no lane ever kept foreign semantics).
            "spill_lanes_total": self._spill_lanes_total,
            "spill_retried_total": self._spill_retried_total,
            "replica_miss_queue_depth": depths,
            "replica_canary_mismatches": {
                int(r): int(n)
                for r, n in (cp.replica_mismatches.items()
                             if cp is not None else ())},
            "replica_audit_entries": list(self._replica_audit_entries),
        }

    # -- elastic resharding plane (parallel/reshard.py) ----------------------

    def _note_reshard_touched(self, replica, src, dst, proto, sport, dport,
                              committed=None, dnat_f=None,
                              dnat_port=None) -> None:
        """Record the home (replica, local slot) of every lane a live
        dispatch may have refreshed/committed/torn down, plus — for
        conntrack-committed lanes — the REPLY-direction entry's slot
        (keyed on the post-DNAT swapped tuple, written in the same
        replica's table).  Conservative: marking an untouched slot just
        re-sweeps one row at catch-up; the one write class NOT derivable
        host-side is the deferred partner-refresh ts stamp (its slot
        comes from cached meta) — a missed ts refresh is the documented
        verdict-safe staleness class, re-proved by the revalidator."""
        plane = self._reshard
        if plane is None:
            return
        tid = self._tenant_id()
        if plane.dirty_all_for(tid):
            return
        N = self._meta.flow_slots
        src = np.asarray(src).astype(np.uint32)
        dst = np.asarray(dst).astype(np.uint32)
        proto = np.asarray(proto).astype(np.int32)
        sport = np.asarray(sport).astype(np.int32)
        dport = np.asarray(dport).astype(np.int32)
        h = hashing.flow_hash(src, dst, proto, sport, dport, xp=np)
        plane.note_touched(np.asarray(replica),
                           (h & np.uint32(N - 1)).astype(np.int64),
                           tenant=tid)
        if committed is None or dnat_f is None:
            return
        com = np.asarray(committed) != 0
        if not com.any():
            return
        dnat = iputil.unflip_u32_array(np.asarray(dnat_f)[com])
        dp = np.asarray(dnat_port)[com].astype(np.int32)
        rh = hashing.flow_hash(dnat.astype(np.uint32), src[com], proto[com],
                               dp, sport[com], xp=np)
        plane.note_touched(np.asarray(replica)[com],
                           (rh & np.uint32(N - 1)).astype(np.int64),
                           tenant=tid)

    def reshard_begin(self, n_data: int, devices=None) -> dict:
        """Begin a LIVE resize of the data axis to `n_data` replicas, on
        the logical device ids `devices` (None: the pool's first ones).

        Builds the target mesh and the next affinity-hash generation
        (dual-topology serving: batches keep resolving against the old
        topology), and registers the budgeted `reshard-migrate`
        maintenance task that walks the flow-cache/conntrack tables and
        re-commits rows to their target ring homes — live tenant worlds
        included, each under its own `_world_ctx` with its own certified
        per-world cutover.  The fleet flips only after the target passes
        its replica-resolved canary and a migrated-row audit sweep; a
        default-world veto aborts back to the old mesh with the
        generation unchanged, while a tenant world's veto latches only
        that world.  -> the plane's status dict."""
        if self._reshard is not None:
            raise RuntimeError(
                "a reshard is already in flight; wait for its cutover or "
                "abort it first (reshard_abort)")
        if self.degraded:
            raise RuntimeError(
                "datapath is degraded (serving last-known-good): the "
                "cutover gate could never certify a target topology — "
                "recover before resizing")
        plane = ReshardPlane(self, int(n_data), devices=devices)
        self._install_reshard_plane(plane)
        return plane.status()

    def _install_reshard_plane(self, plane) -> None:
        """Adopt a constructed ReshardPlane — the ordinary reshard_begin
        above, or the failover plane's emergency evacuation / certified
        readmission (which build their planes directly: the evacuation
        must skip reshard_begin's degraded refusal by design) — and
        register its budgeted migration task."""
        self._reshard = plane
        self._maintenance.register(MaintenanceTask(
            "reshard-migrate", self._maint_reshard,
            budget=self._reshard_budget, priority=4,
            shed_when_degraded=True))

    def _maint_reshard(self, now: int, budget: int) -> int:
        """The reshard plane's maintenance-task runner: budgeted
        migration windows while migrating, then the certified cutover
        (true cost reported unclamped — the scheduler's overrun path
        meters it)."""
        plane = self._reshard
        if plane is None:
            return 0
        return plane.advance(now, budget)

    def reshard_status(self):
        """The in-flight resize's progress (None when no resize is in
        flight) — see ReshardPlane.status."""
        return None if self._reshard is None else self._reshard.status()

    def reshard_abort(self, reason: str = "operator abort") -> None:
        """Abandon the in-flight resize: the old mesh keeps serving, the
        affinity generation never flips, target structures are dropped."""
        if self._reshard is None:
            raise RuntimeError("no reshard in flight")
        self._reshard.abort(reason)

    def arm_reshard_faults(self, plan, name: str) -> None:
        """Chaos hook (tests): arm the per-tenant forced-canary-veto
        sites f"{name}.tenant_canary.t{tid}" consulted by the per-world
        cutover certification (ReshardPlane._certify_world) — a
        deterministic single-world veto without corrupting state."""
        self._reshard_faults = (plan, str(name))
        plan.bind_recorder(getattr(self, "_flightrec", None))

    def tenant_reshard_resync(self, tid: int, now: int) -> dict:
        """Re-home ONE latched tenant world onto the current fleet
        topology (the readmission half of a per-world canary veto): the
        full migrate + certify + flip walk for just that world, under
        the same veto rules — a second veto re-latches, journaled.
        Refused while a fleet resize is in flight (the plane's own
        per-world migration would race this walk)."""
        if self._reshard is not None:
            raise RuntimeError(
                "a reshard is in flight; the latched world re-certifies "
                "at that plane's cutover — wait for it")
        return resync_world(self, int(tid), int(now))

    def _finish_reshard(self, plane) -> None:
        """Plane lifecycle callback (cutover or abort): unregister the
        migration task and fold the plane's meters into the engine's."""
        if self._reshard is plane:
            self._reshard = None
            self._maintenance.unregister("reshard-migrate")
        if self._failover is not None:
            # Evacuation/readmission outcomes fold into the failover
            # state machine; ordinary resizes pass through untouched.
            self._failover.note_reshard_finished(plane)

    def reshard_stats(self) -> dict:
        """Elastic-mesh observability (schema-stable whether or not a
        resize is in flight, the JAX engine's): the live affinity-topology
        generation, migration progress/volume, resident target rows, and
        cutover/abort counters — rendered as the reshard metric
        families."""
        plane = self._reshard
        st = plane.status() if plane is not None else None
        migrated = self._reshard_migrated_total + (
            plane.migrated_rows if plane is not None else 0)
        return {
            "topology_generation": self._topo_gen,
            "active": int(plane is not None),
            "phase": None if st is None else st["phase"],
            "target_n_data": None if st is None else st["n_data_to"],
            "progress_ratio": 0.0 if st is None else st["progress_ratio"],
            "migrated_rows_total": migrated,
            # Cutover catch-up volume: slots the dirty-row sweep walked
            # (the full O(slots) fallback only after a whole-cache write).
            "catchup_rows_total": self._reshard_catchup_total + (
                plane.catchup_scanned if plane is not None else 0),
            "resident_rows": (plane.resident_rows if plane is not None
                              else self._reshard_resident_rows),
            "requeued_total": self._reshard_requeued_total,
            "cutovers_total": self._reshard_cutovers,
            "aborts_total": self._reshard_aborts,
            "last_span": self._last_reshard_span,
            # Tenant-labeled resize observability: rows migrated into
            # tenant worlds (folded at flip; the live plane's in-flight
            # rows ride on top), per-world cutover vetoes, and the live
            # plane's world count.
            "tenant_rows_total": self._reshard_tenant_rows_total + (
                plane.tenant_rows() if plane is not None else 0),
            "tenant_vetoes_total": self._reshard_tenant_vetoes,
            "tenant_worlds_migrating": (len(plane.worlds)
                                        if plane is not None else 0),
        }

    # -- replica-loss failover plane (parallel/failover.py) ------------------

    def _maint_replica_health(self, now: int, budget: int) -> int:
        """The `replica-health` maintenance-task runner: one probe round
        per grant, plus evacuation begin/retry and auto-readmission
        (NOT shed when degraded — a degraded mesh is exactly when
        replica loss must still be detected)."""
        fo = self._failover
        if fo is None:
            return 0
        return fo.advance(now, budget)

    def arm_failover_faults(self, plan, name: str) -> None:
        """FlakyDatapath hook: arm the f"{name}.replica_dead" /
        f"{name}.replica_wedge" sites on the failover plane (no-op when
        the plane is disabled)."""
        if self._failover is not None:
            self._failover.arm(plan, name)

    def failover_stats(self) -> dict:
        """Replica-loss failover observability (schema-stable whether or
        not the plane is enabled, the JAX engine's; rendered as the
        failover metric families in observability/metrics.py)."""
        fo = self._failover
        if fo is None:
            return {"enabled": 0, "n_shards": 0, "phase": "disabled",
                    "quarantined_shard": None, "mask_active": 0,
                    "probes_total": 0, "probe_failures_total": 0,
                    "slow_dispatches_total": 0, "quarantines_total": 0,
                    "evacuations_total": 0, "readmissions_total": 0,
                    "remiss_total": 0, "requeued_total": 0,
                    "fail_streaks": {}, "probe_rounds": 0,
                    "probe_history": [],
                    "tenants_pending_evacuation": []}
        return {"enabled": 1, "n_shards": fo._orig_n, **fo.status()}

    def failover_readmit(self) -> dict:
        """Operator re-admission: a pre-flip heal unmasks; an evacuated
        replica rejoins via the ordinary certified grow-resize — never a
        blind flip.  -> refreshed failover stats."""
        if self._failover is None:
            raise RuntimeError(
                "the failover plane is not enabled (failover=True)")
        st = self._failover.readmit(mode="operator")
        return {"enabled": 1, "n_shards": self._failover._orig_n, **st}

def _flip_first(t: torch.Tensor) -> torch.Tensor:
    """A copy of t with bit 0 of its first word flipped."""
    t = t.clone()
    t[0] ^= 1
    return t
