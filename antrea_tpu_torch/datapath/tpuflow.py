"""TpuflowDatapath: the datapath engine of the PyTorch port, the card behind
the Datapath boundary (the port of antrea_tpu/datapath/tpuflow.py).

Owns the device tensors (rules, services, forwarding tables, flow-cache and
affinity state) of one datapath instance and realizes the bundle and commit
semantics of the reference's OVS binding layer:

  install_bundle    compile -> (drs', dsvc', gen+1) swap, certified by the
                    commit plane's canary (datapath/commit.py).
  apply_group_delta the incremental address-group delta: O(affected
                    columns) host work and a small DeltaTable upload, no
                    recompile; the classify patches the rows of the lanes a
                    slot covers (ops/match.delta_overlay).  Overflow and
                    named ports fold into a full recompile.
  generation        the cookie round: bumping it invalidates cached denials
                    while established connections persist.

Every step runs the full per-packet walk (models/forwarding
.pipeline_step_full), staged (B1 under fused=True) or one-pass (B3, with
fused=True and prune_budget > 0).  A dual_stack engine keys its cache on
wide (10-word) keys and takes v6 lanes; it runs the staged rounds only (the
one-pass step is v4-only), and StepResult gains the wide views dnat_key
and peer_key.  The step updates the state tensors in
place; a bundle's attribution remap writes a new flow-meta tensor, so the
commit plane's retained snapshot keeps the pre-remap rows.

Under async_slowpath the step runs the fast path alone (phases=0) and
admits its misses to the slow-path engine's queue (datapath/slowpath);
drain_slowpath classifies them in coalesced batches through the bare
pipeline step.  With overlap_commits a drain's outputs are read back by a
deferred finalizer: the drain's state writes are in stream order before the
next step's reads, which is the lost-update guard.

Cached rule attribution follows rule IDENTITY across bundles
(_remap_cached_attribution), as in the JAX engine.

Tenant worlds (datapath/tenancy.py) swap the engine's per-world fields in
and out: each world has its own rung-padded rule tensors and quota-sized
state on the engine's device, and steps through the same kernels.  The
serving batcher (serving/batcher.py) packs mixed-tenant lanes onto a ladder
of canonical batch sizes, its padding lanes masked out by `valid`.  With
persist_dir the engine restores its PolicySet, services, topology, tenant
worlds and a monotonic generation on construction (datapath/persist.py,
the round journal in native/store.py); the flow cache starts empty.

Entry points run on the card unless the caller passes device="cpu" (on CPU
tensors every kernel wrapper runs its plain version).  The JAX engine's own
refusals stay ConfigErrors with its words.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..apis.controlplane import GroupMember
from ..apis.service import ServiceEntry
from ..compiler import topology
from ..compiler.compile import ACT_ALLOW, ACT_DROP, compile_policy_set
from ..compiler.ir import PolicySet
from ..compiler.services import compile_services
from ..compiler.topology import FWD_TUNNEL, Topology, compile_topology
from ..config import ConfigError
from ..models import forwarding as fwd
from ..models import pipeline as pl
from ..observability.flightrec import emit_into
from ..observability.metrics import Histogram
from ..observability.telemetry import TelemetryPlane
from ..ops import match
from ..ops.match import (PRUNE_HIST_BOUNDS, DeltaTable, PruneAutotuner,
                         resolve_device, ruleset_from_numpy, to_host)
from ..packet import Packet, PacketBatch
from ..utils import ip as iputil
from . import persist
from .audit import AuditableDatapath
from .commit import TransactionalDatapath
from .interface import Datapath, DatapathStats, DatapathType, StepResult
from .maintenance import MaintainableDatapath
from .slowpath import ADMIT_HOLD
from .tenancy import TenantedDatapath, TenantSpec

def _rid(ids: list, idx: int):
    """Stored rule INDEX -> stable rule id, None for default/vanished — the
    one attribution-resolution rule shared by dump/trace/audit."""
    return ids[idx] if 0 <= idx < len(ids) and ids[idx] else None


class _RuleIds:
    """_rid over a whole (B,) index column at once: the ids as an object
    array with a trailing None, built once per rule list."""

    def __init__(self):
        self._ids = None
        self._arr = None

    def __call__(self, ids: list, idx: np.ndarray) -> list:
        if ids is not self._ids:
            self._arr = np.array([x if x else None for x in ids] + [None],
                                 dtype=object)
            self._ids = ids
        n = len(ids)
        return self._arr[np.where((idx >= 0) & (idx < n), idx, n)].tolist()


class TpuflowDatapath(TenantedDatapath, MaintainableDatapath,
                      TransactionalDatapath, AuditableDatapath,
                      persist.PersistableDatapath, Datapath):
    # The per-world swap set (datapath/tenancy.py): the JAX engine's list
    # and the port's rule-id caches (_RuleIds, one pair a world: a shared
    # pair would rebuild its id array at every swap).  The one-pass meta
    # and the delta overlay's slot count ride _meta / _meta_step, the
    # overlay's tables _drs.ip_delta, and its host mirror _delta_host, so
    # they swap with their world.  Shared across worlds, as in the JAX
    # engine: the service view (_services, _dsvc), forwarding (_topo,
    # _ft, _rt, _dft), the prune plane and its meters (K is the default
    # world's; tenant worlds never retune it), the slow-path queue and
    # its overlap ring (a tenant drain's finalizer re-enters its owner
    # world, datapath/tenancy._tenant_drain_dispatch), the device, and
    # every scheduler and observability object.
    # tests/test_torch_tenancy.py pins this list.
    _TENANT_WORLD_FIELDS = (
        "_ps", "_cps", "_drs", "_meta", "_meta_step", "_state", "_gen",
        "_has_named_ports", "_n_deltas", "_delta_host", "_name_gids",
        "_gid_ident", "_group_members", "_static_blocks", "_member_meta",
        "_stats_in", "_stats_out", "_bytes_in", "_bytes_out",
        "_default_allow", "_default_deny", "_evictions", "_reclaims",
        "_state_mutations", "_pipe_kw", "_persist_dirty",
        "_rule_ids_in", "_rule_ids_out",
    )

    def __init__(
        self,
        ps: Optional[PolicySet] = None,
        services: Optional[list[ServiceEntry]] = None,
        *,
        flow_slots: int = 1 << 20,
        aff_slots: int = 1 << 18,
        ct_timeout_s: int = 3600,
        miss_chunk: int = 4096,
        delta_slots: int = 128,
        ct_syn_timeout_s=None,
        ct_other_new_s=None,
        ct_other_est_s=None,
        fused: bool = False,
        node_ips: Optional[list[str]] = None,
        node_name: str = "",
        persist_dir: Optional[str] = None,
        feature_gates=None,
        topology: Optional[Topology] = None,
        dual_stack: bool = False,
        async_slowpath: bool = False,
        miss_queue_slots: int = 1 << 16,
        admission: str = "forward",
        drain_batch: int = 4096,
        autotune_drain: bool = False,
        autotune_bounds: Optional[tuple] = None,
        overlap_commits: bool = False,
        canary_probes: int = 64,
        audit_window: int = 64,
        audit_divergence_trip: Optional[int] = None,
        maint_budget: Optional[int] = None,
        maint_clock=None,
        flightrec_slots: int = 1024,
        realization_slots: int = 256,
        prune_budget: int = 0,
        autotune_prune: bool = False,
        second_chance: bool = False,
        telemetry: bool = False,
        miss_source_rate: Optional[float] = None,
        miss_source_burst: Optional[int] = None,
        serving_batcher: bool = False,
        canonical_sizes=None,
        flush_depth: Optional[int] = None,
        flush_deadline: Optional[int] = None,
        serving_ring_slots: Optional[int] = None,
        device=None,
    ):
        from ..features import DEFAULT_GATES

        self._device = resolve_device(device)
        gates = feature_gates or DEFAULT_GATES
        if canary_probes == 0 and audit_divergence_trip is not None:
            raise ConfigError(
                "canary_probes=0 disables the canary, but "
                "audit_divergence_trip escalation recovers through a "
                "canary-gated recompile — enable probes or drop the "
                "explicit trip"
            )
        audit_divergence_trip = (8 if audit_divergence_trip is None
                                 else audit_divergence_trip)
        if prune_budget < 0:
            raise ConfigError(
                f"prune_budget must be >= 0, got {prune_budget}")
        if autotune_prune and prune_budget <= 0:
            raise ConfigError(
                "autotune_prune retunes the aggregate-prune K budget, but "
                "prune_budget=0 disables the aggregate layer — set an "
                "initial prune_budget (e.g. 4) to autotune from")
        # The one-pass step is v4-only: fused + dual_stack + pruning is
        # refused, not silently downgraded (tpuflow.py:175).
        if fused and dual_stack and prune_budget > 0:
            raise ConfigError(
                "the one-kernel fast path (fused=True with prune_budget "
                "> 0) is v4-only; dual-stack instances use the staged "
                "kernel (drop fused or prune_budget, or dual_stack)")
        if delta_slots < 0:
            raise ConfigError(f"delta_slots must be >= 0, got {delta_slots}")
        self._prune_tuner = None
        if autotune_prune:
            self._prune_tuner = PruneAutotuner(prune_budget)
            prune_budget = self._prune_tuner.budget  # snap to the ladder
        self._prune_budget = int(prune_budget)
        self._fused = bool(fused)
        self._prune_skips = 0
        self._prune_fallbacks = 0
        self._prune_classified = 0
        self._prune_retunes = 0
        self._prune_hist = Histogram(bounds=PRUNE_HIST_BOUNDS)
        self._gates = gates
        # Per-entry traffic counters ride the FlowExporter gate.
        self._flow_stats = gates.enabled("FlowExporter")
        # Wide (10-word) flow keys, the v6 frontend and forwarding tables.
        self._dual_stack = bool(dual_stack)
        self._init_slowpath(async_slowpath, dual_stack, miss_queue_slots,
                            admission, drain_batch, autotune_drain,
                            autotune_bounds, overlap_commits,
                            miss_source_rate, miss_source_burst)
        self._node_ips = list(node_ips or [])
        self._node_name = node_name
        self._delta_slots = delta_slots
        self._rule_ids_in, self._rule_ids_out = _RuleIds(), _RuleIds()
        self._pipe_kw = dict(
            flow_slots=flow_slots, aff_slots=aff_slots,
            ct_timeout_s=ct_timeout_s, miss_chunk=miss_chunk,
            ct_syn_timeout_s=ct_syn_timeout_s,
            ct_other_new_s=ct_other_new_s,
            ct_other_est_s=ct_other_est_s,
            # Misses classify through B1 (staged) or B3 (one-pass, with
            # prune_budget > 0); off, the classify runs in plain torch on
            # the engine's device.
            fused=fused,
            second_chance=second_chance,
            telemetry=telemetry,
        )
        self._ps = ps if ps is not None else PolicySet()
        self._services = list(services or [])
        self._topo = topology
        self._gen = 0
        # Restart recovery (datapath/persist.py): constructed without
        # explicit state, the engine reloads the last committed snapshot
        # and resumes with a monotonic generation; the flow cache starts
        # empty (flows re-classify, never re-verdict differently).
        self._init_persist(persist_dir, ps, services)
        self._state = self._init_pipeline_state(flow_slots, aff_slots)
        self._reset_world_counters()
        # Wall time of step() as the caller sees it (dispatch, device walk
        # and the read-back of the outputs).
        self.step_hist = Histogram()
        if self._topo is None:
            self._topo = Topology()
        self._compile_rules()
        self._compile_services()
        self._compile_topology()
        self._init_observability(flightrec_slots, realization_slots)
        # Before the maintenance scheduler, which registers the telemetry
        # sentinel against it.
        if telemetry:
            self._telemetry = TelemetryPlane()
        self._init_commit_plane(canary_probes=canary_probes)
        self._init_audit_plane(audit_window=audit_window,
                               audit_divergence_trip=audit_divergence_trip)
        self._init_maintenance(maint_budget=maint_budget,
                               maint_clock=maint_clock)
        self._init_tenancy()
        self._init_serving(serving_batcher, canonical_sizes=canonical_sizes,
                           flush_depth=flush_depth,
                           flush_deadline=flush_deadline,
                           ring_slots=serving_ring_slots)

    # -- placement hooks (a mesh engine overrides them) -----------------------

    @property
    def device(self) -> torch.device:
        return self._device

    def _init_pipeline_state(self, flow_slots: int, aff_slots: int):
        return pl.init_state(flow_slots, aff_slots, device=self._device,
                             key_words=10 if self._dual_stack else 4)

    @property
    def _addr_cols(self) -> int:
        """Address columns of a key row: 2 (v4) or 8 (wide)."""
        return self._meta.key_words - 2

    def _place_rules(self, cps):
        """Compile -> device rule tensors + match meta (tenant worlds pad
        the host tables' entry axes first, datapath/tenancy._pad_tables)."""
        host, match_meta = to_host(cps, delta_slots=self._delta_slots,
                                   prune_budget=self._prune_budget)
        host = self._pad_tables(host)
        return ruleset_from_numpy(host, self._device), match_meta

    def _place_services(self, dsvc: pl.DeviceServiceTables):
        return dsvc

    def _place_forwarding(self, dft: fwd.DeviceForwardingTables):
        return dft

    def _place_delta(self, dt: DeltaTable) -> DeltaTable:
        return dt

    # -- Datapath ------------------------------------------------------------

    @property
    def datapath_type(self) -> DatapathType:
        return DatapathType.TPUFLOW

    @property
    def generation(self) -> int:
        return self._gen

    def _install_bundle_impl(self, ps=None, services=None) -> int:
        # Compile stage of the commit plane: compile-before-assign, so a
        # rejected bundle leaves spec and tables on the previous value; the
        # rules compile against the STAGED service view (toServices).
        staged = list(services) if services is not None else None
        staged_dsvc = None
        if staged is not None:
            staged_dsvc = self._place_services(pl.svc_to_device(
                compile_services(staged, node_ips=self._node_ips,
                                 node_name=self._node_name), self._device))
        if ps is not None:
            old_in = self._cps.ingress.rule_ids
            old_out = self._cps.egress.rule_ids
            self._ps = ps
            self._compile_rules(services=staged)
            self._remap_cached_attribution(old_in, old_out)
        elif staged is not None and self._cps.has_svcref:
            self._compile_rules(services=staged)
        if staged is not None:
            self._services = staged
            self._dsvc = staged_dsvc
        self._gen += 1
        if self._slowpath is not None:
            # The swap marks the cache epoch stale: the next drain's fused
            # maintenance reclaims the stale denials' slots.
            self._slowpath.mark_stale(self._gen)
        return self._gen

    def _remap_cached_attribution(self, old_in: list, old_out: list) -> None:
        """Remap the stored rule indices of cached entries old -> new by
        stable rule id (vanished rules lose attribution).  Writes a new
        flow-meta tensor: the commit plane's snapshot keeps the old one."""
        if (list(old_in) == list(self._cps.ingress.rule_ids)
                and list(old_out) == list(self._cps.egress.rule_ids)):
            return
        new_in = {rid: i for i, rid in enumerate(self._cps.ingress.rule_ids)}
        new_out = {rid: i for i, rid in enumerate(self._cps.egress.rule_ids)}

        def remap_arr(old_ids: list, new_pos: dict) -> torch.Tensor:
            # Index space is the STORED +1 encoding: 0 = no attribution.
            arr = np.zeros(len(old_ids) + 1, np.int64)
            for i, rid in enumerate(old_ids):
                pos = new_pos.get(rid, -1) if rid else -1
                arr[i + 1] = pos + 1 if pos >= 0 else 0
            return torch.from_numpy(arr).to(self._device)

        r_in = remap_arr(old_in, new_in)
        r_out = remap_arr(old_out, new_out)
        meta = self._state.flow.meta.clone()
        RC = pl._meta_cols(self._addr_cols)[2]
        rp = meta[:, RC]
        # int32 >> is arithmetic: the & 0xFFFF keeps the high half's bits.
        vi = (rp & 0xFFFF).long().clamp(0, r_in.shape[0] - 1)
        vo = ((rp >> 16) & 0xFFFF).long().clamp(0, r_out.shape[0] - 1)
        meta[:, RC] = pl._wrap32(r_in[vi] | (r_out[vo] << 16))
        self._state = self._state._replace(
            flow=self._state.flow._replace(meta=meta))
        self._state_mutations += 1

    def _apply_group_delta_impl(self, group_name, added_ips, removed_ips) -> int:
        # Incremental compile stage of the commit plane (which snapshots the
        # retained generation first, so a delta that throws rolls back).
        gids = self._name_gids.get(group_name, [])
        if not gids and group_name not in self._group_members:
            raise KeyError(f"unknown group {group_name!r}")
        rows: list[tuple[tuple[int, int], int, int]] = []  # (range, gid, sign)
        own = self._group_members.setdefault(group_name, Counter())
        ranges_before = self._ranges_of(group_name)
        # Named-port rules bind membership through synthetic narrowed
        # groups a raw-group delta cannot patch: every delta recompiles.
        need_recompile = self._has_named_ports

        for ip in added_ips:
            r = iputil.cidr_to_range(ip)
            if not _contains(self._ranges_of(group_name), r):
                for gid in gids:
                    if not self._covered_by_others(gid, group_name, r):
                        rows.append((r, gid, +1))
            own[ip] += 1
        for ip in removed_ips:
            if own[ip] <= 0:
                continue
            own[ip] -= 1
            if own[ip] == 0:
                del own[ip]
            r = iputil.cidr_to_range(ip)
            residual = self._ranges_of(group_name)
            if _contains(residual, r):
                continue  # another member/block still provides this range
            if _overlaps(residual, r):
                need_recompile = True
                continue
            for gid in gids:
                if self._covered_by_others(gid, group_name, r):
                    continue
                if self._partially_covered_by_others(gid, group_name, r):
                    need_recompile = True
                else:
                    rows.append((r, gid, -1))

        self._sync_ps_members(group_name)
        if not need_recompile and self._ranges_of(group_name) == ranges_before:
            # Net no-op delta: keep the generation, burn no slots.
            return self._gen
        if need_recompile or self._n_deltas + len(rows) > self._delta_slots:
            # Fold everything into a fresh compile (membership mirrors are
            # already current).
            self._compile_rules()
        elif rows:
            self._append_deltas(rows)
        self._gen += 1
        if self._slowpath is not None:
            self._slowpath.mark_stale(self._gen)
        return self._gen

    def install_topology(self, topo: Topology) -> None:
        ft = compile_topology(topo)
        self._topo = topo
        self._ft = ft
        self._rt = topology.resolve_topology(topo)
        self._dft = self._place_forwarding(fwd.fwd_to_device(ft,
                                                             self._device))
        self._persist_topology()
        self._audit_refresh_golden()

    def _lane(self, a, dtype=np.int32) -> torch.Tensor:
        """A host column -> an int32 tensor on the engine's device (u32
        values keep their bits)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(dtype, copy=False)).to(self._device)

    def _flipped(self, ips) -> torch.Tensor:
        return self._lane(iputil.flip_u32(np.asarray(ips, np.uint32)))

    def _v6_lanes(self, batch: PacketBatch):
        """Batch -> the pipeline's v6 lane tuple (src6w_f, dst6w_f, is6), or
        None.  A dual-stack engine always passes the wide lanes (all v4
        when the batch has none); a v4 engine refuses a v6 batch."""
        if not self._dual_stack:
            if batch.has_v6:
                raise ValueError(
                    "batch carries v6 lanes but this datapath is v4-only; "
                    "construct it with dual_stack=True")
            return None
        if batch.src_ip6 is None:
            z = self._flipped(np.zeros((batch.size, 4), np.uint32))
            return z, z.clone(), self._lane(np.zeros(batch.size, np.int32))
        return (self._flipped(batch.src_ip6), self._flipped(batch.dst_ip6),
                self._lane(batch.is6))

    @staticmethod
    def _wide_keys(wide_col: np.ndarray) -> list:
        """(B, 4) flipped word rows -> per-lane combined keys (v4-mapped
        rows: the v4 value).  The JAX engine's keys_of: one numpy pass,
        then Python big ints for the lanes that carry a v6 address."""
        words = iputil.unflip_u32_array(wide_col).astype(np.int64)
        mapped = ((words[:, 0] == 0) & (words[:, 1] == 0)
                  & (words[:, 2] == 0xFFFF))
        keys = words[:, 3].tolist()
        for i in np.nonzero(~mapped)[0]:
            w = words[i]
            keys[i] = iputil.V6_OFF + ((int(w[0]) << 96) | (int(w[1]) << 64)
                                       | (int(w[2]) << 32) | int(w[3]))
        return keys

    @staticmethod
    def _wide_row_key(row) -> int:
        """4 flipped words -> combined-keyspace int (mapped form = v4)."""
        w = [iputil.unflip_u32(int(x)) for x in row]
        v = (w[0] << 96) | (w[1] << 64) | (w[2] << 32) | w[3]
        return v & 0xFFFFFFFF if (v >> 32) == 0xFFFF else iputil.V6_OFF + v

    @staticmethod
    def _to_host(out: dict) -> dict:
        """Device outputs -> numpy, in two read-backs: every (B,) column
        stacked, then the rest."""
        lanes = [k for k, v in out.items() if v.dim() == 1
                 and v.shape[0] == out["code"].shape[0] and v.dtype == torch.int32]
        o = {}
        if lanes:
            stacked = torch.stack([out[k] for k in lanes]).cpu().numpy()
            o.update(zip(lanes, stacked))
        rest = [k for k in out if k not in o]
        if rest:
            flat = torch.cat([out[k].reshape(-1).to(torch.int32)
                              for k in rest]).cpu().numpy()
            i = 0
            for k in rest:
                n = out[k].numel()
                o[k] = flat[i:i + n].reshape(tuple(out[k].shape))
                i += n
        return o

    def step(self, batch: PacketBatch, now: int, *, valid=None) -> StepResult:
        t0 = time.perf_counter()
        self._maintenance.observe(now)
        if self._realization is not None:
            self._realization.first_hit(self._gen, batch.size)
        try:
            return self._step(batch, now, valid=valid)
        finally:
            dt = time.perf_counter() - t0
            self.step_hist.observe(dt)
            if self._telemetry is not None:
                # The same wall seconds into every (scope, regime) the
                # batch classified under (_telemetry_account queued them).
                self._telemetry.observe_step(dt)

    def _step(self, batch: PacketBatch, now: int, valid=None) -> StepResult:
        v6 = self._v6_lanes(batch)
        # Byte lengths clamped once: a negative length never decrements a
        # counter.
        lens = np.maximum(batch.lens(), 0)
        state, out = fwd.pipeline_step_full(
            self._state,
            self._drs,
            self._dsvc,
            self._dft,
            self._flipped(batch.src_ip),
            self._flipped(batch.dst_ip),
            self._lane(batch.proto),
            self._lane(batch.src_port),
            self._lane(batch.dst_port),
            self._lane(batch.in_ports()),
            int(now),
            int(self._gen),
            self._lane(batch.flags()),
            self._lane(batch.arp_ops()) if batch.arp_op is not None else None,
            self._lane(lens) if self._flow_stats else None,
            meta=self._meta_step,
            v6=v6,
            valid=(None if valid is None
                   else torch.from_numpy(np.asarray(valid, bool)).to(
                       self._device)),
        )
        self._state = state
        self._state_mutations += 1
        o = self._to_host(out)
        self._evictions += int(o["n_evict"])
        self._prune_account(o)
        pending = None
        if self._async:
            # The fast step's miss lanes into the bounded queue; their
            # outputs carry the admission policy's provisional verdict
            # until a drain classifies the flow (tenant worlds clamp the
            # mask to the tenant's quota; no-ops on the default world).
            pending = o["miss"]
            admitted, dropped = self._slowpath.admit(
                self._queue_cols(batch, batch.flags(), lens,
                                 tenant=self._tenant_id()),
                self._tenant_admit_mask(pending != 0), now)
            self._tenant_note_admitted(admitted, dropped)
        # After admission: sheds this batch caused classify it as
        # attack-shed.
        self._telemetry_account(o, batch.size)
        in_ids = self._cps.ingress.rule_ids
        out_ids = self._cps.egress.rule_ids
        self._count_metrics(o, in_ids, out_ids, lens, pending=pending)
        if self._deny is not None:
            self._deny_verdicts(batch, o["code"], pending, now)
        unflip = iputil.unflip_u32_array
        dnat_key = peer_key = None
        if self._dual_stack:
            dnat_key = self._wide_keys(o["dnat_w_f"])
            # Non-tunnel lanes report 0, not the mapped zero's key.
            peer_key = [
                k if (kind == FWD_TUNNEL and port != -1) else 0
                for k, kind, port in zip(self._wide_keys(o["peer_w"]),
                                         o["fwd_kind"], o["out_port"])]
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
            n_miss=int(o["n_miss"]),
            spoofed=o["spoofed"],
            punt=o["punt"],
            mcast_idx=o["mcast_idx"],
            l7_redirect=o["l7_redirect"],
            fwd_kind=o["fwd_kind"],
            out_port=o["out_port"],
            peer_ip=np.where(
                (o["fwd_kind"] == FWD_TUNNEL) & (o["out_port"] != -1),
                unflip(o["peer_f"]), 0,
            ).astype(np.uint32),
            dec_ttl=o["dec_ttl"],
            tc_act=o["tc_act"],
            tc_port=o["tc_port"],
            dnat_key=dnat_key,
            peer_key=peer_key,
        )

    def stats(self) -> DatapathStats:
        return DatapathStats(
            ingress=dict(self._stats_in),
            egress=dict(self._stats_out),
            ingress_bytes=dict(self._bytes_in),
            egress_bytes=dict(self._bytes_out),
            default_allow=self._default_allow,
            default_deny=self._default_deny,
        )

    def dump_flows(self, now: int) -> list[dict]:
        """Live flow-cache entries decoded to host dicts (the conntrack
        dump a flow exporter polls); reply-direction entries carry
        reply=True and their un-DNAT frontend in dnat_ip/dnat_port."""
        return self._dump_flows_state(self._state, now)

    def _dump_flows_state(self, state: pl.PipelineState, now: int) -> list[dict]:
        flow = state.flow
        keys = flow.keys[:-1].cpu().numpy().astype(np.int64)
        meta = flow.meta[:-1].cpu().numpy().astype(np.int64)
        ts = flow.ts[:-1].cpu().numpy()
        pkts = (flow.pkts[:-1].cpu().numpy().view(np.uint32).astype(np.int64)
                + (flow.pkts_hi[:-1].cpu().numpy().astype(np.int64) << 32))
        octets = (flow.octets[:-1].cpu().numpy().view(np.uint32).astype(
            np.int64) + (flow.octets_hi[:-1].cpu().numpy().astype(np.int64)
                         << 32))
        A = self._addr_cols
        DC, M1C, RC, _ZC = pl._meta_cols(A)
        kpg = keys[:, A + 1]
        live, _entry_gen = self._live_mask(keys, meta, ts, now)
        out = []

        def unflip_ip(v: int) -> str:
            return iputil.u32_to_ip(iputil.unflip_u32(v))

        def wide_ip(row) -> str:
            """4 flipped words -> address string (mapped form = v4)."""
            return iputil.key_to_ip(self._wide_row_key(row))

        for i in np.nonzero(live)[0]:
            pg = int(kpg[i])
            gen = (pg >> 9) & pl.GEN_ETERNAL
            code, svc_idx, dnat_port = pl._unpack_meta1(int(meta[i, M1C]))
            rule_in, rule_out = pl._unpack_rules(int(meta[i, RC]))
            if A == 2:
                src, dst = unflip_ip(keys[i, 0]), unflip_ip(keys[i, 1])
                dnat = unflip_ip(meta[i, DC])
            else:
                src, dst = wide_ip(keys[i, 0:4]), wide_ip(keys[i, 4:8])
                dnat = wide_ip(meta[i, 0:4])
            out.append({
                "src": src,
                "dst": dst,
                "sport": (int(keys[i, A]) >> 16) & 0xFFFF,
                "dport": int(keys[i, A]) & 0xFFFF,
                "proto": pg & 0xFF,
                "reply": bool(pg & (1 << 31)),
                "committed": gen == pl.GEN_ETERNAL,
                "code": code,
                "svc_idx": svc_idx,
                "dnat_ip": dnat,
                "dnat_port": dnat_port,
                "ingress_rule": _rid(self._cps.ingress.rule_ids, rule_in),
                "egress_rule": _rid(self._cps.egress.rule_ids, rule_out),
                "last_seen": int(ts[i]),
                "packets": int(pkts[i]),
                "bytes": int(octets[i]),
            })
        return out

    def mcast_group(self, idx: int) -> Optional[dict]:
        return topology.mcast_group_of(self._rt, idx)

    def cache_stats(self) -> dict:
        """Flow-cache census: occupied/committed/denial entries, slots, and
        the live entries overwritten by another tuple since construction."""
        c = {k: int(v) for k, v in pl.cache_stats(self._state).items()}
        c["evictions"] = self._evictions
        c["reclaims"] = self._reclaims
        return c

    # -- aggregated-bitmap prune plane ----------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        emit_into(self, kind, **fields)

    def prune_stats(self) -> Optional[dict]:
        """Prune-plane observability (None when prune_budget=0)."""
        if self._prune_budget <= 0:
            return None
        return {
            "budget": self._prune_budget,
            "skips_total": self._prune_skips,
            "fallbacks_total": self._prune_fallbacks,
            "classified_total": self._prune_classified,
            "retunes_total": self._prune_retunes,
            "autotune": int(self._prune_tuner is not None),
            "hist": self._prune_hist,
        }

    def _prune_account(self, o: dict) -> None:
        """Fold one step's prune counters into the plane's meters and feed
        the K autotuner one decision point."""
        if self._prune_budget <= 0 or "n_prune_skips" not in o:
            return
        self._prune_skips += int(np.asarray(o["n_prune_skips"]).sum())
        fb = int(np.asarray(o["n_prune_fb"]).sum())
        self._prune_fallbacks += fb
        hist = np.asarray(o["prune_cand_hist"], np.int64)
        hist = hist.reshape(-1, len(PRUNE_HIST_BOUNDS) + 2).sum(axis=0)
        self._prune_hist.add_counts(hist[:-1], float(hist[-1]))
        classified = int(hist[:-1].sum())
        self._prune_classified += classified
        if self._prune_tuner is not None and self._active_tenant is None:
            new = self._prune_tuner.observe(classified, fb)
            if new != self._prune_budget:
                self._retune_prune(new)

    def _retune_prune(self, budget: int) -> None:
        """Swap the prune K rung: a meta-only change (the aggregate tables
        are K-independent), journaled as `prune-retune`."""
        old, self._prune_budget = self._prune_budget, int(budget)
        mm = self._meta.match._replace(prune_budget=self._prune_budget)
        self._meta = self._meta._replace(match=mm)
        self._meta_step = self._meta_step._replace(match=mm)
        self._prune_retunes += 1
        self._emit("prune-retune", budget_from=int(old),
                   budget_to=int(self._prune_budget),
                   fallbacks_total=int(self._prune_fallbacks),
                   classified_total=int(self._prune_classified))

    # -- async slow path (datapath/slowpath engine callbacks) ----------------
    # drain_slowpath, dump_miss_queue and slowpath_stats live on the Datapath
    # base; the classify and scan callbacks are the engine's.

    def _drain_meta(self, chunk: int) -> pl.PipelineMeta:
        """The drain step's meta for one coalesced chunk: one slow-path
        round (miss_chunk == chunk) with the fused eviction and aging
        commit pass (drain_reclaim).  A meta only: nothing compiles per
        chunk."""
        return self._meta._replace(miss_chunk=int(chunk), drain_reclaim=True)

    def _drain_classify(self, block: dict, now: int):
        """Classify and commit one popped queue block through the bare
        pipeline step (one round at the engine's current chunk, padding
        lanes masked out by `valid`) and publish the new cache state.

        With overlap_commits the read-back of the outputs (metrics, the
        eviction counters) is returned as a deferred finalizer for the
        engine's two-slot ring: the state was updated in place, in stream
        order before whatever the next step enqueues, and nothing here
        waits for the device.  The rule ids are captured at dispatch, so a
        bundle that lands while the commit is staged does not remap what
        this drain classified."""
        split = self._tenant_drain_split(block)
        if split is not None:
            return self._tenant_drain_dispatch(split, now)
        t0 = time.perf_counter()
        # The scope of a deferred finalize is the world that classified it.
        tel_tid = self._tenant_id() if self._telemetry is not None else 0
        k = len(block["src_ip"])
        D = self._slowpath.drain_batch
        if k > D:
            # An explicit begin_drain(n > drain_batch) popped a wider
            # block: pad to the next power of two so every popped row
            # classifies.
            D = 1 << (k - 1).bit_length()

        def pad(col, dtype=np.int32):
            out = np.zeros(D, dtype)
            out[:k] = np.asarray(col)[:k].astype(dtype)
            return out

        src = pad(block["src_ip"], np.uint32)
        dst = pad(block["dst_ip"], np.uint32)
        proto = pad(block["proto"])
        flags = pad(block["flags"])
        lens = np.maximum(pad(block["lens"]), 0)
        valid = np.arange(D) < k
        # The full walk's commit gating: multicast misses classify but never
        # cache, a FIN/RST TCP miss never establishes.
        no_commit = pl.no_commit_mask(dst, proto, flags)
        state, out = pl.pipeline_step(
            self._state, self._drs, self._dsvc, self._flipped(src),
            self._flipped(dst), self._lane(proto),
            self._lane(pad(block["src_port"])),
            self._lane(pad(block["dst_port"])), int(now), int(self._gen),
            meta=self._drain_meta(D), valid=self._lane(valid, bool),
            no_commit=self._lane(no_commit, bool), flags=self._lane(flags),
            lens=self._lane(lens) if self._flow_stats else None)
        self._state = state
        self._state_mutations += 1
        in_ids = self._cps.ingress.rule_ids
        out_ids = self._cps.egress.rule_ids

        def finalize():
            o = self._to_host(out)
            self._evictions += int(o["n_evict"])
            self._reclaims += int(o["n_reclaim"])
            self._prune_account(o)
            # A queued packet's attribution counts once, here (its fast
            # step's image was provisional and uncounted).
            self._count_metrics(
                {key: o[key][valid]
                 for key in ("code", "ingress_rule", "egress_rule")},
                in_ids, out_ids, lens[valid])
            if self._telemetry is not None:
                # A drain is its own dispatch: its counters and its
                # dispatch-to-read-back seconds go to the "drain" regime.
                self._telemetry.account(o)
                dt = time.perf_counter() - t0
                self._telemetry.observe_scoped("engine", "drain", dt)
                if tel_tid:
                    self._telemetry.observe_scoped(
                        f"tenant:{tel_tid}", "drain", dt)

        if self._overlap:
            return finalize
        finalize()
        return None

    def _epoch_maintain(self, now: int) -> tuple[int, int]:
        """Aging and stale-generation revalidation in one pass."""
        state, n_aged, n_stale = pl._maintain_scan(
            self._state, int(now), int(self._gen),
            timeouts=self._meta.timeouts)
        self._state = state
        self._state_mutations += 1
        return int(n_aged), int(n_stale)

    def _epoch_revalidate(self) -> int:
        state, n = pl._revalidate_scan(self._state, int(self._gen))
        self._state = state
        self._state_mutations += 1
        return int(n)

    def _epoch_age_scan(self, now: int) -> int:
        state, n = pl._age_scan(self._state, int(now),
                                timeouts=self._meta.timeouts)
        self._state = state
        self._state_mutations += 1
        return int(n)

    # -- the phase profiler ----------------------------------------------------

    def profile(self, batch: PacketBatch, fresh: Optional[PacketBatch] = None,
                *, n_new: Optional[int] = None, now: int = 1000,
                k_small: int = 2, k_big: int = 8, repeats: int = 2,
                mode: str = "sync") -> dict:
        """The churn loop's phase breakdown (models/profile.py): `batch` is
        the warmed hot set, and each timed step replaces its last n_new
        lanes with the next window of fresh flows from `fresh` (None: the
        never-miss regime).  Every mode works on a copy of the state, so
        the engine's observable state is unchanged.

        Modes: "sync" (PHASE_CHAIN), "async" (the fast step and the
        coalesced drain, ASYNC_PHASE_CHAIN), "overlap" (the drain of window
        i-1 beside the fast step of window i), "maintenance" (the async
        cadence with the fused maintenance scan riding every step),
        "prune" (a staged pruned instance, the classify split at the
        aggregate gather), "fused" (a one-pass instance) and "telemetry"
        (one instrumented step of the bare pipeline: its tel_* counters
        by name)."""
        from ..models import profile as prof

        if batch.has_v6 or (fresh is not None and fresh.has_v6):
            raise ValueError(
                "profile() probes are v4-only; dual-stack instances "
                "profile their v4 lanes (the wide fast path is shared)")

        def cols(b):
            return (self._flipped(b.src_ip), self._flipped(b.dst_ip),
                    self._lane(b.proto), self._lane(b.src_port),
                    self._lane(b.dst_port))

        hot = cols(batch)
        if mode == "telemetry":
            _, out = pl.pipeline_step(
                pl.clone_state(self._state), self._drs, self._dsvc, *hot,
                int(now), int(self._gen),
                meta=self._meta._replace(telemetry=True))
            return {"mode": "telemetry", "batch": batch.size,
                    "counters": {k[4:]: int(v) for k, v in out.items()
                                 if k.startswith("tel_")}}
        if mode == "prune" and self._meta.onepass:
            raise ValueError(
                "profile(mode='prune') attributes the staged pruned walk, "
                "but this instance serves the one-pass step: use "
                "mode='fused' (or construct with fused=False)")
        fns = {"sync": prof.profile_churn,
               "async": prof.profile_churn_async,
               "overlap": prof.profile_churn_overlap,
               "maintenance": prof.profile_churn_maintenance,
               "prune": prof.profile_churn_prune,
               "fused": prof.profile_churn_fused}
        if mode not in fns:
            raise ValueError(f"unknown profile mode {mode!r}")
        pool = cols(fresh) if fresh is not None else None
        return fns[mode](self._meta, self._state, self._drs, self._dsvc, hot,
                         pool, n_new=n_new, now0=now, gen=self._gen,
                         k_small=k_small, k_big=k_big, repeats=repeats)

    # -- commit plane hooks (datapath/commit.py) ------------------------------

    def _commit_snapshot(self, group: Optional[str] = None) -> dict:
        """The retained last-known-good generation: every attribute a
        bundle/delta commit can touch.  Device tables are replaced
        wholesale by a commit (never written in place), and the state's
        flow meta is replaced by the attribution remap, so they snapshot by
        reference; `group` scopes a delta's snapshot to the touched
        group's membership mirrors."""
        if group is None:
            ps_members = [
                (g, list(g.members))
                for table in (self._ps.address_groups,
                              self._ps.applied_to_groups)
                for g in table.values()
            ]
            group_members = {k: Counter(v)
                             for k, v in self._group_members.items()}
            delta_host = {k: v.copy() for k, v in self._delta_host.items()}
            touched = None
        else:
            ps_members = [
                (g, list(g.members))
                for g in (self._ps.address_groups.get(group),
                          self._ps.applied_to_groups.get(group))
                if g is not None
            ]
            group_members = self._group_members
            delta_host = self._delta_host
            own = self._group_members.get(group)
            touched = (group, None if own is None else Counter(own))
        return {
            "gen": self._gen,
            "ps": self._ps,
            "ps_members": ps_members,
            "services": self._services,
            "cps": self._cps,
            "drs": self._drs,
            "dsvc": self._dsvc,
            "meta": self._meta,
            "meta_step": self._meta_step,
            "state": self._state,
            "has_named_ports": self._has_named_ports,
            "n_deltas": self._n_deltas,
            "delta_host": delta_host,
            "name_gids": self._name_gids,
            "gid_ident": self._gid_ident,
            "group_members": group_members,
            "touched": touched,
            "static_blocks": self._static_blocks,
            "member_meta": (self._member_meta if group is not None else
                            {k: dict(v) for k, v in self._member_meta.items()}),
        }

    def _commit_restore(self, snap: dict) -> None:
        self._gen = snap["gen"]
        self._ps = snap["ps"]
        for g, members in snap["ps_members"]:
            g.members = members
        self._services = snap["services"]
        self._cps = snap["cps"]
        self._drs = snap["drs"]
        self._dsvc = snap["dsvc"]
        self._meta = snap["meta"]
        self._meta_step = snap["meta_step"]
        self._prune_budget = snap["meta"].match.prune_budget
        if self._prune_tuner is not None:
            self._prune_tuner = PruneAutotuner(self._prune_budget)
        self._state = snap["state"]
        self._has_named_ports = snap["has_named_ports"]
        self._n_deltas = snap["n_deltas"]
        self._delta_host = snap["delta_host"]
        self._name_gids = snap["name_gids"]
        self._gid_ident = snap["gid_ident"]
        self._group_members = snap["group_members"]
        if snap["touched"] is not None:
            name, ctr = snap["touched"]
            if ctr is None:
                self._group_members.pop(name, None)
            else:
                self._group_members[name] = ctr
        self._static_blocks = snap["static_blocks"]
        self._member_meta = snap["member_meta"]
        self._state_mutations += 1

    def _canary_classify(self, batch: PacketBatch, now: int) -> np.ndarray:
        """Fresh-walk verdict of each probe through the current tables,
        state untouched: the bare classify with the serving meta (fused:
        B1, or B2 under pruning) and the pending deltas; a dual-stack engine
        takes the full trace walk (its wide lanes are what needs
        certifying), as the JAX engine does."""
        if self._dual_stack:
            return self._trace_out(self._state, batch, now)["fresh_code"]
        cls = match.classify_batch(
            self._drs, self._flipped(batch.src_ip),
            self._flipped(batch.dst_ip), self._lane(batch.proto),
            self._lane(batch.dst_port), meta=self._meta.match,
            fused=self._meta.fused, delta_n=self._meta.delta_n)
        return cls["code"].cpu().numpy()

    # -- audit plane hooks (datapath/audit.py) --------------------------------

    def _audit_slots(self) -> int:
        return self._meta.flow_slots

    def _audit_rule_digests(self) -> dict:
        """Checksum-scrub digests of the rule-side device tensor groups:
        the compiled rule set (delta table included), the service tables,
        the forwarding tables."""
        return {
            "drs": pl.tensor_digest(pl.tree_leaves(self._drs)),
            "dsvc": pl.tensor_digest(pl.tree_leaves(self._dsvc)),
            "dft": pl.tensor_digest(pl.tree_leaves(self._dft)),
        }

    def _audit_state_digest(self) -> int:
        return pl.tensor_digest(pl.tree_leaves(self._state))

    def _audit_reupload(self) -> None:
        """Rule-side self-heal: rebuild every rule-side device tensor from
        its host mirror (compiled set, services, topology, delta mirror)."""
        drs, _match_meta = self._place_rules(self._cps)
        self._drs = drs
        self._upload_delta_table()
        self._compile_services()
        self._dft = self._place_forwarding(fwd.fwd_to_device(self._ft,
                                                             self._device))

    def _live_mask(self, keys, meta, ts, now):
        """Liveness of decoded (int64) entry rows: occupied, within the
        per-state idle timeout, valid under the current generation."""
        A = self._addr_cols
        ZC = pl._meta_cols(A)[3]
        kpg = keys[:, A + 1]
        entry_gen = (kpg >> 9) & pl.GEN_ETERNAL
        gen_w = self._gen % pl.GEN_ETERNAL
        tmo = pl.entry_timeout(
            (meta[:, ZC] >> 29) & 1, kpg & 0xFF, self._meta.timeouts, xp=np)
        live = (
            (kpg != 0)
            & ((now - ts) <= tmo)
            & ((entry_gen == pl.GEN_ETERNAL) | (entry_gen == gen_w))
        )
        return live, entry_gen

    def _audit_window(self, cursor: int, k: int, now: int) -> list[dict]:
        """Decode k consecutive flow-cache slots from `cursor` (wrapping)
        into audit rows; live entries only.  The gather runs on the
        device; k rows come back."""
        N = self._meta.flow_slots
        keys_d, meta_d, ts_d = pl.audit_gather(self._state, cursor % N,
                                               window=k)
        return self._decode_audit_rows(keys_d, meta_d, ts_d, now,
                                       lambda i: (cursor + i) % N)

    def _decode_audit_rows(self, keys_d, meta_d, ts_d, now,
                           slot_of) -> list[dict]:
        keys = keys_d.cpu().numpy().astype(np.int64)
        meta = meta_d.cpu().numpy().astype(np.int64)
        ts = ts_d.cpu().numpy()
        A = self._addr_cols
        DC, M1C, RC, _ZC = pl._meta_cols(A)
        kpg = keys[:, A + 1]
        live, entry_gen = self._live_mask(keys, meta, ts, now)
        in_ids = self._cps.ingress.rule_ids
        out_ids = self._cps.egress.rule_ids
        aff_tmo = self._dsvc.aff_timeout.cpu().numpy()
        rows = []
        for i in np.nonzero(live)[0]:
            pg = int(kpg[i])
            code, svc_idx, dnat_port = pl._unpack_meta1(int(meta[i, M1C]))
            rule_in, rule_out = pl._unpack_rules(int(meta[i, RC]))
            if A == 2:
                src = iputil.unflip_u32(int(keys[i, 0]))
                dst = iputil.unflip_u32(int(keys[i, 1]))
                dnat = iputil.unflip_u32(int(meta[i, DC]))
            else:
                src = self._wide_row_key(keys[i, 0:4])
                dst = self._wide_row_key(keys[i, 4:8])
                dnat = self._wide_row_key(meta[i, 0:4])
            rows.append({
                "slot": slot_of(int(i)),
                "src": int(src),
                "dst": int(dst),
                "proto": pg & 0xFF,
                "sport": (int(keys[i, A]) >> 16) & 0xFFFF,
                "dport": int(keys[i, A]) & 0xFFFF,
                "code": code,
                "svc": svc_idx,
                "dnat_ip": int(dnat),
                "dnat_port": dnat_port,
                "rule_in": _rid(in_ids, rule_in),
                "rule_out": _rid(out_ids, rule_out),
                "committed": int(entry_gen[i]) == pl.GEN_ETERNAL,
                "reply": bool(pg & (1 << 31)),
                "aff": bool(0 <= svc_idx < aff_tmo.shape[0]
                            and aff_tmo[svc_idx] > 0),
            })
        return rows

    def _audit_fresh(self, rows: list, now: int) -> list[dict]:
        return self._audit_fresh_state(self._state, rows, now)

    def _audit_dsvc(self):
        return self._dsvc

    def _trace_out(self, state, batch: PacketBatch, now: int) -> dict:
        """pipeline_trace of a batch -> numpy outputs (state untouched)."""
        o = pl.pipeline_trace(
            state, self._drs, self._audit_dsvc(),
            self._flipped(batch.src_ip), self._flipped(batch.dst_ip),
            self._lane(batch.proto), self._lane(batch.src_port),
            self._lane(batch.dst_port), int(now), int(self._gen),
            meta=self._meta, v6=self._v6_lanes(batch))
        return self._to_host(o)

    def _audit_fresh_state(self, state: pl.PipelineState, rows: list,
                           now: int) -> list[dict]:
        """Fresh-walk re-proof of audited entries through the current
        tables, state untouched."""
        pkts = [Packet(src_ip=r["src"], dst_ip=r["dst"], proto=r["proto"],
                       src_port=r["sport"], dst_port=r["dport"])
                for r in rows]
        o = self._trace_out(state, PacketBatch.from_packets(pkts), now)
        in_ids = self._cps.ingress.rule_ids
        out_ids = self._cps.egress.rule_ids
        out = []
        for i in range(len(rows)):
            no_ep = bool(o["no_ep"][i])
            if self._dual_stack:
                dnat = self._wide_row_key(o["dnat_w_f"][i])
            else:
                dnat = iputil.unflip_u32(int(o["dnat_ip_f"][i]))
            out.append({
                "code": int(o["fresh_code"][i]),
                "svc": int(o["svc_idx"][i]),
                "dnat_ip": int(dnat),
                "dnat_port": int(o["dnat_port"][i]),
                "rule_in": (None if no_ep
                            else _rid(in_ids, int(o["ingress_rule"][i]))),
                "rule_out": (None if no_ep
                             else _rid(out_ids, int(o["egress_rule"][i]))),
            })
        return out

    def _audit_evict(self, slots: list) -> None:
        """Repair divergent entries by eviction (their key rows cleared):
        the flows reclassify on their next packet."""
        state, _n = pl.audit_evict(
            self._state, torch.tensor(list(slots), dtype=torch.int32,
                                      device=self._device))
        self._state = state
        self._state_mutations += 1

    def _audit_corrupt(self, kind: str, now: Optional[int] = None) -> str:
        """Chaos-tier injection: real, unaccounted damage the audit scan
        must then detect and repair.  kind "tensor" flips one service-table
        word (or, without services, a delta-table word); any other kind
        flips a sampled cached verdict bit of a live row.  The mutation
        counter is deliberately not bumped."""
        if kind == "tensor":
            if int(self._dsvc.ep_port.shape[0]) > 0:
                col = self._dsvc.ep_port.clone()
                col[0] ^= 1
                self._dsvc = self._dsvc._replace(ep_port=col)
                return "flipped dsvc.ep_port[0] bit 0"
            d = self._drs.ip_delta
            lo = d.lo_f.clone()
            lo[0] ^= 1
            self._drs = self._drs._replace(ip_delta=d._replace(lo_f=lo))
            return "flipped drs.ip_delta.lo_f[0] bit 0"
        keys = self._state.flow.keys[:-1].cpu().numpy().astype(np.int64)
        kpg = keys[:, -1]
        if now is not None:
            meta_np = self._state.flow.meta[:-1].cpu().numpy().astype(
                np.int64)
            ts_np = self._state.flow.ts[:-1].cpu().numpy()
            live, _egen = self._live_mask(keys, meta_np, ts_np, now)
        else:
            gen_w = self._gen % pl.GEN_ETERNAL
            egen = (kpg >> 9) & pl.GEN_ETERNAL
            live = (kpg != 0) & ((egen == pl.GEN_ETERNAL) | (egen == gen_w))
        idx = np.nonzero(live)[0]
        if idx.size == 0:
            return self._audit_corrupt("tensor")
        slot = int(idx[0])
        M1C = pl._meta_cols(self._addr_cols)[1]
        self._state.flow.meta[slot, M1C] ^= 1
        return f"flipped cached verdict bit of slot {slot}"

    def trace(self, batch: PacketBatch, now: int) -> list[dict]:
        """Traceflow analog: per-packet stage observations, state
        untouched (the fresh walk for every packet plus the cache
        lookup)."""
        if not self._gates.enabled("Traceflow"):
            raise RuntimeError("Traceflow feature gate is disabled")
        return self._trace_batch(self._state, batch, now)

    def _trace_batch(self, state: pl.PipelineState, batch: PacketBatch,
                     now: int) -> list[dict]:
        o = self._trace_out(state, batch, now)
        in_ids = self._cps.ingress.rule_ids
        out_ids = self._cps.egress.rule_ids

        from ..compiler.topology import oracle_forward, oracle_spoof

        in_ports = batch.in_ports()
        out = []
        for i in range(batch.size):
            p = batch.packet(i)
            # Addresses flow as combined keys (the spec is family-blind).
            if self._dual_stack:
                dnat_u = self._wide_row_key(o["dnat_w_f"][i])
                cached_dnat = self._wide_row_key(o["cached_dnat_w_f"][i])
            else:
                dnat_u = iputil.unflip_u32(o["dnat_ip_f"][i])
                cached_dnat = iputil.unflip_u32(o["cached_dnat_ip_f"][i])
            if o["reply"][i]:
                eff_dst = p.dst_ip
            elif o["cache_hit"][i]:
                eff_dst = cached_dnat
            else:
                eff_dst = dnat_u
            spoofed = oracle_spoof(self._rt, p.src_ip, int(in_ports[i]))
            f = oracle_forward(self._rt, eff_dst, int(in_ports[i]))
            # Is this 5-tuple in the miss queue, awaiting a drain?
            queued = (self._slowpath is not None
                      and self._slowpath.queue.contains(
                          int(p.src_ip), int(p.dst_ip), int(batch.proto[i]),
                          int(batch.src_port[i]), int(batch.dst_port[i])))
            out.append({
                "queued": queued,
                "cache_hit": bool(o["cache_hit"][i]),
                "est": bool(o["est"][i]),
                "reply": bool(o["reply"][i]),
                "reject_kind": int(o["reject_kind"][i]),
                "snat": int(o["snat"][i]),
                "dsr": int(o["dsr"][i]),
                "svc_idx": int(o["svc_idx"][i]),
                "no_ep": bool(o["no_ep"][i]),
                "dnat_ip": dnat_u,
                "dnat_port": int(o["dnat_port"][i]),
                "egress_code": int(o["egress_code"][i]),
                "egress_rule": _rid(out_ids, int(o["egress_rule"][i])),
                "ingress_code": int(o["ingress_code"][i]),
                "ingress_rule": _rid(in_ids, int(o["ingress_rule"][i])),
                "fresh_code": int(o["fresh_code"][i]),
                "code": int(o["code"][i]),
                "spoofed": spoofed,
                "fwd_kind": f["kind"],
                "out_port": f["out_port"],
            })
        return out

    # -- internals -----------------------------------------------------------

    def _count_metrics(self, o: dict, in_ids: list, out_ids: list,
                       lens=None, pending=None) -> None:
        if not self._gates.enabled("NetworkPolicyStats"):
            return
        # SpoofGuard drops and IGMP punts happen before the policy tables
        # and must not pollute NetworkPolicy metrics.
        spoofed = o.get("spoofed")
        not_spoofed = None if spoofed is None else (spoofed == 0)
        punt = o.get("punt")
        if punt is not None and not_spoofed is not None:
            not_spoofed = not_spoofed & (punt == 0)
        for key, ids, ctr, bctr in (
            ("ingress_rule", in_ids, self._stats_in, self._bytes_in),
            ("egress_rule", out_ids, self._stats_out, self._bytes_out),
        ):
            idx = o[key]
            ok = (idx >= 0) & (idx < len(ids))
            vals = idx[ok]
            if vals.size:
                bc = np.bincount(vals, minlength=len(ids))
                bb = (np.bincount(vals, weights=lens[ok],
                                  minlength=len(ids))
                      if lens is not None else None)
                for r in np.nonzero(bc)[0]:
                    if ids[r]:
                        ctr[ids[r]] += int(bc[r])
                        if bb is not None and bb[r]:
                            bctr[ids[r]] += int(bb[r])
        none_mask = (o["ingress_rule"] < 0) & (o["egress_rule"] < 0)
        if not_spoofed is not None:
            none_mask = none_mask & not_spoofed
        if pending is not None:
            none_mask = none_mask & (pending == 0)
        self._default_allow += int(((o["code"] == 0) & none_mask).sum())
        self._default_deny += int(((o["code"] != 0) & none_mask).sum())

    def _compile_rules(self, services=None) -> None:
        """services: the service view toServices lowering resolves against
        (None: the committed list; install_bundle passes its staged one)."""
        self._has_named_ports = any(
            s.port_name
            for p in self._ps.policies for r in p.rules for s in r.services
        )
        cps = compile_policy_set(
            self._ps,
            services=self._services if services is None else services,
        )
        cps = self._pad_cps(cps)
        pl.check_rule_capacity(cps)
        drs, match_meta = self._place_rules(cps)
        self._cps = cps
        self._drs = drs
        self._meta = pl.PipelineMeta(
            match=match_meta,
            flow_slots=self._pipe_kw["flow_slots"],
            aff_slots=self._pipe_kw["aff_slots"],
            ct_timeout_s=self._pipe_kw["ct_timeout_s"],
            miss_chunk=self._pipe_kw["miss_chunk"],
            ct_syn_timeout_s=self._pipe_kw["ct_syn_timeout_s"],
            ct_other_new_s=self._pipe_kw["ct_other_new_s"],
            ct_other_est_s=self._pipe_kw["ct_other_est_s"],
            fused=self._pipe_kw["fused"],
            # The one-pass step engages when B1's fusion and the aggregate
            # layer are both on (never dual-stack: the constructor refused
            # that combination).
            onepass=bool(self._pipe_kw["fused"]
                         and match_meta.prune_budget > 0
                         and not self._dual_stack),
            key_words=10 if self._dual_stack else 4,
            count_flow_stats=self._flow_stats,
            second_chance=bool(self._pipe_kw["second_chance"]),
            telemetry=bool(self._pipe_kw["telemetry"]),
        )
        # The async fast step masks the slow path out: misses keep the
        # admission policy's provisional verdict (DROP under hold) and are
        # classified by a drain (_drain_meta).
        if self._async:
            self._meta_step = self._meta._replace(
                phases=0,
                miss_code=(ACT_DROP
                           if self._slowpath.admission == ADMIT_HOLD
                           else ACT_ALLOW))
        else:
            self._meta_step = self._meta
        # The compile folded every prior delta.
        D = self._delta_slots
        self._n_deltas = 0
        self._delta_host = {
            "lo_f": np.full(D, 2**31 - 1, np.int32),
            "hi_f": np.full(D, -(2**31), np.int32),
            "sign": np.zeros(D, np.int32),
            "iso": np.zeros(D, np.int32),
            "at_in": np.zeros((D, match_meta.w_in), np.uint32),
            "peer_in": np.zeros((D, match_meta.w_in), np.uint32),
            "at_out": np.zeros((D, match_meta.w_out), np.uint32),
            "peer_out": np.zeros((D, match_meta.w_out), np.uint32),
            "fam": np.zeros(D, np.int32),
            "lo6_w": np.full((D, 4), 2**31 - 1, np.int32),
            "hi6_w": np.full((D, 4), -(2**31), np.int32),
        }
        self._name_gids: dict[str, list[int]] = {}
        self._gid_ident = dict(cps.gid_ident)
        for gid, (_kind, names, _static) in self._gid_ident.items():
            for n in names:
                self._name_gids.setdefault(n, []).append(gid)
        # Membership mirrors for coverage checks and overflow recompiles:
        # refcounted member strings per group, static ipBlocks apart, and
        # an exemplar GroupMember per (group, ip).
        self._group_members: dict[str, Counter] = {}
        self._static_blocks: dict[str, list[tuple[int, int]]] = {}
        self._member_meta: dict[str, dict[str, GroupMember]] = {}
        for name, g in self._ps.address_groups.items():
            c = Counter()
            meta = self._member_meta.setdefault(name, {})
            for m in g.members:
                c[m.ip] += 1
                meta.setdefault(m.ip, m)
            self._group_members[name] = c
            blocks: list[tuple[int, int]] = []
            for b in g.ip_blocks:
                blocks.extend(iputil.ipblock_to_ranges(b.cidr, b.excepts))
            self._static_blocks[name] = blocks
        for name, g in self._ps.applied_to_groups.items():
            meta = self._member_meta.setdefault(name, {})
            for m in g.members:
                meta.setdefault(m.ip, m)
            if name in self._group_members:
                continue  # same-named AddressGroup => same selector/members
            c = Counter()
            for m in g.members:
                c[m.ip] += 1
            self._group_members[name] = c

    def _compile_services(self) -> None:
        self._dsvc = self._place_services(pl.svc_to_device(compile_services(
            self._services, node_ips=self._node_ips, node_name=self._node_name
        ), self._device))

    def _compile_topology(self) -> None:
        self._ft = compile_topology(self._topo)
        self._rt = topology.resolve_topology(self._topo)
        self._dft = self._place_forwarding(fwd.fwd_to_device(self._ft,
                                                             self._device))

    def _ranges_of(self, name: str) -> list[tuple[int, int]]:
        """Current merged ranges of a named group (members + static blocks)."""
        mem = self._group_members.get(name)
        rs: list[tuple[int, int]] = []
        if mem is not None:
            rs.extend(iputil.cidr_to_range(s) for s, c in mem.items() if c > 0)
        rs.extend(self._static_blocks.get(name, ()))
        return iputil.merge_ranges(rs)

    def _covered_by_others(self, gid: int, exclude: str, r: tuple[int, int]) -> bool:
        _kind, names, static = self._gid_ident[gid]
        if _contains(iputil.merge_ranges(list(static)), r):
            return True
        return any(
            _contains(self._ranges_of(n), r) for n in names if n != exclude
        )

    def _partially_covered_by_others(self, gid: int, exclude: str, r) -> bool:
        _kind, names, static = self._gid_ident[gid]
        if _overlaps(iputil.merge_ranges(list(static)), r):
            return True
        return any(
            _overlaps(self._ranges_of(n), r) for n in names if n != exclude
        )

    def _rule_mask(self, gids: np.ndarray, gid: int, w: int) -> np.ndarray:
        """(w,) u32 bitmap of the rules whose dimension gid is `gid`."""
        return match._inc_mask(np.nonzero(gids == gid)[0], w)

    def _append_deltas(self, rows) -> None:
        h = self._delta_host
        cps = self._cps
        mm = self._meta.match
        for (lo, hi), gid, sign in rows:
            i = self._n_deltas
            if lo >= iputil.V6_OFF:
                h["fam"][i] = 1
                h["lo6_w"][i] = iputil.key_to_flipped_words(lo)
                h["hi6_w"][i] = iputil.key_to_flipped_words(hi - 1)
            else:
                h["fam"][i] = 0
                h["lo_f"][i] = iputil.flip_u32(np.uint32(lo))
                h["hi_f"][i] = iputil.flip_u32(np.uint32(hi - 1))  # inclusive
            h["sign"][i] = sign
            h["at_in"][i] = self._rule_mask(cps.ingress.at_gid, gid, mm.w_in)
            h["peer_in"][i] = self._rule_mask(cps.ingress.peer_gid, gid, mm.w_in)
            h["at_out"][i] = self._rule_mask(cps.egress.at_gid, gid, mm.w_out)
            h["peer_out"][i] = self._rule_mask(cps.egress.peer_gid, gid, mm.w_out)
            h["iso"][i] = (1 if gid == cps.iso_in_gid else 0) | (
                2 if gid == cps.iso_out_gid else 0
            )
            self._n_deltas += 1
        self._upload_delta_table()

    def _upload_delta_table(self) -> None:
        """Upload the host delta mirror as the device DeltaTable and set
        the metas' active-slot count (shared by the append path and the
        audit plane's rule-side self-heal)."""
        self._drs = self._drs._replace(
            ip_delta=self._place_delta(self._build_delta_table()))
        self._meta = self._meta._replace(delta_n=self._n_deltas)
        self._meta_step = self._meta_step._replace(delta_n=self._n_deltas)

    def _build_delta_table(self) -> DeltaTable:
        """The host delta mirror as a DeltaTable on the engine's device."""
        h = self._delta_host
        host = DeltaTable(**h, n=np.int32(self._n_deltas))
        return match.from_numpy(DeltaTable, host, self._device)

    # -- tenancy hooks ---------------------------------------------------------

    def _reset_world_counters(self) -> None:
        """Zero the per-world counters (a new engine's and a new tenant
        world's)."""
        self._stats_in: Counter = Counter()
        self._stats_out: Counter = Counter()
        self._bytes_in: Counter = Counter()
        self._bytes_out: Counter = Counter()
        self._default_allow = 0
        self._default_deny = 0
        self._evictions = 0
        self._reclaims = 0

    def _tenant_init_world(self, spec: TenantSpec, ps) -> None:
        """Re-initialize the swapped-out engine fields as a fresh world for
        `spec`: its own compiled (rung-padded) tensors, its own state
        tables at the quota rungs on the engine's device, zeroed counters,
        generation 0.  The caller (tenant_create) holds the saved world and
        restores it afterwards."""
        self._ps = ps
        self._gen = 0
        self._pipe_kw = dict(self._pipe_kw, flow_slots=spec.quota,
                             aff_slots=spec.aff_quota)
        self._reset_world_counters()
        self._state_mutations = 0
        self._persist_dirty = False
        self._rule_ids_in, self._rule_ids_out = _RuleIds(), _RuleIds()
        self._compile_rules()
        self._state = self._init_pipeline_state(spec.quota, spec.aff_quota)

    def _tenant_occupied(self, fields: dict) -> int:
        return int(pl.cache_stats(fields["_state"])["occupied"])

    def _sync_ps_members(self, name: str) -> None:
        """Keep the held PolicySet's group membership in line with the
        membership mirror, so an overflow recompile sees it."""
        own = self._group_members.get(name, Counter())
        meta = self._member_meta.get(name, {})
        members = [
            meta.get(s) or GroupMember(ip=s)
            for s, cnt in sorted(own.items())
            for _ in range(cnt)
        ]
        ag = self._ps.address_groups.get(name)
        if ag is not None:
            ag.members = list(members)
        atg = self._ps.applied_to_groups.get(name)
        if atg is not None:
            atg.members = list(members)


def _contains(ranges: list[tuple[int, int]], r: tuple[int, int]) -> bool:
    lo, hi = r
    return any(lo >= lo2 and hi <= hi2 for lo2, hi2 in ranges)


def _overlaps(ranges: list[tuple[int, int]], r: tuple[int, int]) -> bool:
    lo, hi = r
    return any(lo < hi2 and hi > lo2 for lo2, hi2 in ranges)
