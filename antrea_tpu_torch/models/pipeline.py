"""The datapath pipeline step: the PyTorch port of
antrea_tpu/models/pipeline.py for the v4 regime, staged or one-pass, with
the phase-mask surface the async engine's fast and drain steps and the
profiler (models/profile.py) run, and the off-step maintenance scans.

One step takes a packet batch through a direct-mapped flow cache in front
of the full classifier:

  FAST PATH (every packet): flow-cache probe on the 5-tuple.  A hit yields
    the cached verdict, DNAT resolution, rule attribution and service id.
    ALLOW entries carry the ETERNAL generation (conntrack-committed, they
    survive policy changes); denials carry the rule generation.  Hits
    refresh the entry's idle time, and (deferred) its partner direction;
    the first reply-direction hit CONFIRMs both directions; FIN/RST on an
    established TCP entry tears both directions down.
  SLOW PATH (cache misses, in rounds of miss_chunk lanes): ServiceLB
    (frontend lookup, session affinity, endpoint choice by flow hash),
    classification of the post-DNAT tuple (ops/match, through the B1 CUDA
    kernel when fused), and the commit of the forward and reply entries
    with deterministic last-writer-wins on slot collisions.
  ONE-PASS SLOW PATH (meta.onepass: fused over an aggregate-pruned world):
    ServiceLB over the whole batch, then kernel B3 (ops/onepass) decodes the
    probe, prunes, matches, resolves and packs the commit rows of every lane
    in one launch; lanes with more than K candidate superblocks are re-walked
    at full width (B1), and one interleaved scatter commits the batch.

Unlike the JAX step, this one updates the state's tensors IN PLACE (the
flow cache is ~0.2 GB at 2**22 slots) and returns the same state object;
callers must not rely on the old state after a step.  The result is bit for
bit the JAX step's: lookups see the state at batch start, inserts land in
lane order, affinity lookups see the start-of-batch table in every round.
The step reads one small vector back to the host (which conditional phases
run, and the miss count that sizes the round loop), and one more to list
the miss lanes when there are misses.  Under pruning each classify reads
back whether any lane has a candidate and lists its fallback lanes; the
one-pass slow path lists its fallback lanes once.

All tensors are int32 words; u32 quantities keep their bits in int32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..apis.controlplane import PROTO_TCP
from ..compiler.compile import ACT_ALLOW, ACT_REJECT, CompiledPolicySet
from ..compiler.services import ServiceTables
from ..ops import consumer, hashing, onepass
from ..ops.match import (BIG, PRUNE_HIST_BOUNDS, DeviceRuleSet, StaticMeta,
                         _dim_index, _refuse, _resolve, _svcref_key,
                         classify_batch, from_numpy, resolve_device,
                         ruleset_from_numpy, to_host)

MISS = -1
# Generation tag reserved for conntrack-committed (ALLOW) entries; rule
# generations are taken mod GEN_ETERNAL so they never collide with it.
GEN_BITS = 22
GEN_ETERNAL = (1 << GEN_BITS) - 1
# Bit 31 of the packed proto/gen key word marks a REPLY-direction entry.
REPLY_BIT = -(2**31)

# Flow-entry meta column 3: bit 31 SNAT mark, bit 30 DSR mark, bit 29
# CONFIRMED (two-way traffic seen), bits 0-28 the partner-refresh stamp
# (seconds mod 2^29).
PREF_MASK = (1 << 29) - 1
CONF_BIT = 1 << 29
DSR_BIT = 1 << 30

# REJECT synthesis kinds: TCP gets an RST, everything else an ICMP
# port-unreachable.
REJECT_NONE = 0
REJECT_TCP_RST = 1
REJECT_ICMP_UNREACH = 2

# TCP wire flag bits consumed by conntrack teardown.
TCP_FIN = 0x01
TCP_RST = 0x04
_TEARDOWN_FLAGS = TCP_FIN | TCP_RST

# Slow-path phase bits (PipelineMeta.phases).  Masking a phase substitutes
# cheap defaults, so the profiler can attribute the step phase by phase, and
# the async engine's fast step runs at phases=0 (misses keep the fast-path
# image and are admitted, not classified).  Synchronous steps run PH_ALL.
#   PH_SLOW    the slow path at all: miss compaction, rounds, output writes
#   PH_LB      ServiceLB frontend lookup, affinity, endpoint choice
#   PH_CLS     the classifier on the post-DNAT tuple (B1/B2, or B3)
#   PH_CLS_SUM the pruned classifier's aggregate phase alone (summary_only);
#              only meaningful without PH_CLS and with prune_budget > 0
#   PH_COMMIT  flow-cache insert rows, both-direction scatters, learns
#   PH_EVICT   the eviction census (reads the commit's insert targets)
PH_SLOW = 1
PH_LB = 2
PH_CLS = 4
PH_COMMIT = 8
PH_EVICT = 16
PH_CLS_SUM = 32
PH_ALL = PH_SLOW | PH_LB | PH_CLS | PH_COMMIT | PH_EVICT | PH_CLS_SUM

_I32 = torch.int32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wrap, as
    JAX's int32 arithmetic does)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(_I32)


def _pair16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi << 16) | lo in int32, wrapping into the sign bit like JAX."""
    return _wrap32((hi.to(torch.int64) << 16) | lo.to(torch.int64))


def _prune_bucket_counts(cand: torch.Tensor, mask: torch.Tensor):
    """Per-lane candidate-superblock counts -> per-bucket counts plus a
    trailing value-sum element, (len(PRUNE_HIST_BOUNDS) + 2,) int32.  The
    bucket of a count is bisect_left over PRUNE_HIST_BOUNDS."""
    bounds = torch.tensor(PRUNE_HIST_BOUNDS, dtype=_I32, device=cand.device)
    idx = (cand[:, None] > bounds[None, :]).sum(dim=1)
    mi = mask.to(_I32)
    counts = torch.zeros(len(PRUNE_HIST_BOUNDS) + 1, dtype=_I32,
                         device=cand.device).index_add_(0, idx, mi)
    vsum = (cand * mi).sum(dtype=_I32)
    return torch.cat([counts, vsum[None]])


def reject_kind_of(code, proto):
    """REJECT synthesis kind per lane: TCP -> RST, anything else -> ICMP
    port-unreachable; 0 when not a REJECT."""
    return torch.where(
        code == ACT_REJECT,
        torch.where(proto == PROTO_TCP, REJECT_TCP_RST, REJECT_ICMP_UNREACH),
        REJECT_NONE,
    ).to(_I32)


class FlowCache(NamedTuple):
    """Direct-mapped unified flow cache (the JAX package's layout).

      keys (N+1, 4) int32: [src_f, dst_f, sport<<16|dport, proto|0x100|gen<<9]
        (bit 31 of the last word: REPLY_BIT)
      meta (N+1, 4) int32: [dnat_ip_f, meta1, rules, snat<<31|dsr<<30|conf<<29|pref]
        meta1 = code(2) | (svc_idx+1)(14) | dnat_port(16)
        rules = (rule_in+1)(16) | (rule_out+1)(16)
      ts (N+1,) int32: last-seen seconds
      pkts/octets/pkts_hi/octets_hi (N+1,) int32: traffic counters, kept for
        layout parity; this port does not count (count_flow_stats).
    Row N is a write dump for masked scatters."""

    keys: torch.Tensor
    meta: torch.Tensor
    ts: torch.Tensor
    pkts: torch.Tensor
    octets: torch.Tensor
    pkts_hi: torch.Tensor
    octets_hi: torch.Tensor


class AffinityTable(NamedTuple):
    """Session-affinity learn table (slow-path only); row M is a dump."""

    key_client: torch.Tensor  # (M+1,) sign-flipped client ip
    key_svc: torch.Tensor  # (M+1,) service index
    ep: torch.Tensor  # endpoint slot within the service bucket row, +1
    ts: torch.Tensor  # creation seconds (hard timeout, no refresh)


class PipelineState(NamedTuple):
    flow: FlowCache
    aff: AffinityTable


class DeviceServiceTables(NamedTuple):
    uip_f: torch.Tensor
    ppk: torch.Tensor
    slot_svc: torch.Tensor
    n_ep: torch.Tensor
    has_ep: torch.Tensor
    aff_timeout: torch.Tensor
    ep_base: torch.Tensor  # (P,) offsets into the flat endpoint arrays
    ep_ip_f: torch.Tensor  # (E,) flat
    ep_port: torch.Tensor  # (E,) flat
    slot_snat: torch.Tensor  # (NU, MAXP) 0/1 per-frontend SNAT-mark flag
    prog_svc: torch.Tensor  # (P,) owning service index per program
    prog_dsr: torch.Tensor  # (P,) 0/1 per-program DSR delivery flag
    # v6 frontend tables: carried for layout parity, unused (v4 only).
    uip6_w: torch.Tensor
    ppk6: torch.Tensor
    slot_svc6: torch.Tensor
    slot_snat6: torch.Tensor
    ep_ipw_f: torch.Tensor


class PipelineMeta(NamedTuple):
    """Static configuration of a step (plain ints)."""

    match: StaticMeta
    flow_slots: int
    aff_slots: int
    # Per-state conntrack lifetimes: ct_timeout_s is the confirmed-TCP
    # lifetime; syn covers half-open TCP, other_* non-TCP.  None = inherit.
    ct_timeout_s: int
    miss_chunk: int  # slow-path round size
    ct_syn_timeout_s: Optional[int] = None
    ct_other_new_s: Optional[int] = None
    ct_other_est_s: Optional[int] = None
    # Classify misses through the B1 consumer (the CUDA kernel on the card),
    # or B2 under pruning.
    fused: bool = False
    # Slow-path phase mask (PH_* bits): PH_ALL for synchronous steps, 0 for
    # the async fast step, cumulative chains for the profiler.
    phases: int = PH_ALL
    # Verdict of miss lanes the slow path did not classify (observable only
    # with PH_SLOW masked): the async admission policy, ACT_ALLOW for a
    # provisional forward, ACT_DROP to hold until the drain classifies.
    miss_code: int = ACT_ALLOW
    # The drain step's fused maintenance: the eviction census also reads
    # each insert target's ts and CONFIRMED bit and splits overwrites of
    # dead rows (idle-expired, or stale-generation denials) out of n_evict
    # into n_reclaim.
    drain_reclaim: bool = False
    # The one-pass slow path (kernel B3 over the whole batch) instead of
    # the miss rounds; needs the aggregate layer (match.prune_budget > 0).
    onepass: bool = False

    @property
    def timeouts(self) -> tuple[int, int, int, int]:
        """(tcp_syn, tcp_est, other_new, other_est), Nones resolved."""
        t = self.ct_timeout_s
        return (
            self.ct_syn_timeout_s if self.ct_syn_timeout_s is not None else t,
            t,
            self.ct_other_new_s if self.ct_other_new_s is not None else t,
            self.ct_other_est_s if self.ct_other_est_s is not None else t,
        )


def svc_to_host(st: ServiceTables) -> DeviceServiceTables:
    """Numpy-resident service tables."""
    return DeviceServiceTables(
        **{f: np.asarray(getattr(st, f)) for f in DeviceServiceTables._fields})


def services_from_numpy(dsvc_np, device=None) -> DeviceServiceTables:
    """Numpy service tables (this package's svc_to_host, or the JAX
    package's) -> tensors on `device`."""
    return from_numpy(DeviceServiceTables, dsvc_np, resolve_device(device))


def svc_to_device(st: ServiceTables, device=None) -> DeviceServiceTables:
    return services_from_numpy(svc_to_host(st), device)


_STATE_TREE = {(PipelineState, "flow"): FlowCache,
               (PipelineState, "aff"): AffinityTable}


def state_from_numpy(state_np, device=None) -> PipelineState:
    """A numpy pipeline state (e.g. jax.device_get of the JAX package's
    PipelineState, v4 layout) -> this package's state on `device`."""
    return from_numpy(PipelineState, state_np, resolve_device(device),
                      _STATE_TREE)


def init_state(flow_slots: int = 1 << 20, aff_slots: int = 1 << 18,
               device=None) -> PipelineState:
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    n = flow_slots + 1
    flow = FlowCache(keys=zeros(n, 4), meta=zeros(n, 4), ts=zeros(n),
                     pkts=zeros(n), octets=zeros(n), pkts_hi=zeros(n),
                     octets_hi=zeros(n))
    m = aff_slots + 1
    aff = AffinityTable(key_client=zeros(m), key_svc=zeros(m), ep=zeros(m),
                        ts=zeros(m))
    return PipelineState(flow=flow, aff=aff)


def _meta_cols(A: int) -> tuple[int, int, int, int]:
    """Meta-row column indices (dn_narrow, meta1, rules, zcol)."""
    return (0, 1, 2, 3) if A == 2 else (3, 4, 5, 6)


def _raw_bits(x_f: torch.Tensor) -> torch.Tensor:
    """Sign-flipped int32 -> int32 whose u32 reinterpretation is the raw
    value."""
    return x_f ^ -(2**31)


def _winner_mask(n_slots, slots, mask, dump):
    """Deterministic last-writer-wins for duplicate slots in one batch: the
    highest lane index targeting a slot wins.  scatter_reduce 'amax' is
    deterministic on CUDA, unlike index_put_ with duplicate indices."""
    B = slots.shape[0]
    slots_m = torch.where(mask, slots, dump)
    order = torch.arange(B, dtype=_I32, device=slots.device)
    winner = torch.full((n_slots + 1,), -1, dtype=_I32, device=slots.device)
    winner.scatter_reduce_(0, slots_m, order, reduce="amax", include_self=True)
    return (winner[slots_m] == order) & mask


def _scatter_last(arr, slots, vals, mask, dump):
    """In place: masked scatter of vals (M,) or rows (M, K) into arr (N+1,)
    or (N+1, K) with last-writer-wins; losers and masked lanes write the
    dump row."""
    win = _winner_mask(arr.shape[0] - 1, slots, mask, dump)
    arr[torch.where(win, slots, dump)] = vals


def _pack_meta1(code, svc_idx, dnat_port):
    return _wrap32(code.to(torch.int64) | ((svc_idx.to(torch.int64) + 1) << 2)
                   | (dnat_port.to(torch.int64) << 16))


def _unpack_meta1(m1):
    code = m1 & 3
    svc_idx = ((m1 >> 2) & 0x3FFF) - 1
    dnat_port = (m1 >> 16) & 0xFFFF
    return code, svc_idx, dnat_port


def _pack_rules(rule_in, rule_out):
    # Rule indices fit 16 bits each (check_rule_capacity).  Stored +1 so the
    # zero word means "no rule".
    return _wrap32((rule_in.to(torch.int64) + 1)
                   | ((rule_out.to(torch.int64) + 1) << 16))


def _unpack_rules(rp):
    return (rp & 0xFFFF) - 1, ((rp >> 16) & 0xFFFF) - 1


def _fused_pack_rows(src_f, dst_f, proto, sport, dport, pp, f_code, svc_idx,
                     dnat_ip, dnat_port, snat_m, dsr_m, f_ri, f_ro, miss_m,
                     nc_m, now, gen_w, n_slots, pmask):
    """The commit rows of a set of lanes: the forward entry, and the
    reply-direction entry keyed on the post-DNAT tuple with ports swapped,
    whose meta carries the un-DNAT rewrite; ALLOW entries as ETERNAL
    (conntrack), denials tagged with the generation; DSR lanes commit no
    reply leg.  The torch twin of B3's packing (pipeline.py:579).
    -> dict(committed, ins, rev_ins, rev_slot, keys8 (M, 8), meta8 (M, 8))."""
    committed = miss_m & (f_code == ACT_ALLOW) & ~nc_m
    ins = miss_m & ~nc_m
    rev_ins = ins & committed & (dsr_m == 0)
    egen = torch.where(committed, GEN_ETERNAL, gen_w)
    pg_ins = (proto | 0x100 | (egen << 9)).to(_I32)
    m1 = _pack_meta1(f_code, svc_idx, dnat_port)
    rules_p = _pack_rules(f_ri, f_ro)
    pref_col = torch.full_like(proto, now & pmask)
    zcol = (pref_col
            | torch.where(snat_m > 0, REPLY_BIT, 0)
            | torch.where(dsr_m > 0, DSR_BIT, 0)).to(_I32)
    rev_h = hashing.flow_hash(_raw_bits(dnat_ip), _raw_bits(src_f), proto,
                              dnat_port, sport)
    rev_slot = (rev_h & (n_slots - 1)).to(_I32)
    rev_pg = proto | 0x100 | (GEN_ETERNAL << 9) | REPLY_BIT
    keys8 = torch.stack([src_f, dst_f, pp, pg_ins, dnat_ip, src_f,
                         _pair16(dnat_port, sport), rev_pg], dim=1)
    meta8 = torch.stack([dnat_ip, m1, rules_p, zcol, dst_f,
                         _pack_meta1(f_code, svc_idx, dport), rules_p,
                         pref_col], dim=1)
    return dict(committed=committed, ins=ins, rev_ins=rev_ins,
                rev_slot=rev_slot, keys8=keys8, meta8=meta8)


class PolicyCapacityError(ValueError):
    """A compiled policy set exceeds the 16-bit packed rule-attribution
    space of the flow cache."""


def check_rule_capacity(cps: CompiledPolicySet) -> None:
    for dt in (cps.ingress, cps.egress):
        if dt.n_rules >= 0xFFFE:
            raise PolicyCapacityError(
                f"flow-cache rule packing supports < 65534 rules per "
                f"direction, got {dt.n_rules}"
            )


def make_pipeline(
    cps: CompiledPolicySet,
    svc: ServiceTables,
    *,
    flow_slots: int = 1 << 20,
    aff_slots: int = 1 << 18,
    ct_timeout_s: int = 3600,
    miss_chunk: int = 4096,
    ct_syn_timeout_s: Optional[int] = None,
    ct_other_new_s: Optional[int] = None,
    ct_other_est_s: Optional[int] = None,
    fused: bool = False,
    device=None,
    dual_stack: bool = False,
    count_flow_stats: bool = False,
    prune_budget: int = 0,
    second_chance: bool = False,
    onepass: Optional[bool] = None,
    telemetry: bool = False,
):
    """-> (step fn, initial PipelineState, (DeviceRuleSet, DeviceServiceTables)).

    step(state, drs, dsvc, src_f, dst_f, proto, sport, dport, now, gen,
    flags=None) -> (state', out dict); state' is `state`, updated in place.
    drs/dsvc are explicit arguments so a rule-set swap is a call with new
    tensors and a bumped gen.  now and gen are ints (seconds, generation);
    the lane inputs are (B,) int32 tensors on the tables' device.

    device None means the card (raises without CUDA); "cpu" runs every
    kernel's plain version.  prune_budget > 0 builds the aggregate tables:
    misses then classify through the pruned walk, and fused=True upgrades
    the slow path to the one-pass kernel unless onepass=False pins the
    staged rounds (onepass=True demands it).  dual_stack, count_flow_stats,
    second_chance and telemetry are not ported: they raise
    NotImplementedError.
    """
    dev = resolve_device(device)
    _refuse(dual_stack=dual_stack, count_flow_stats=count_flow_stats,
            second_chance=second_chance, telemetry=telemetry)
    check_rule_capacity(cps)
    drs_np, match_meta = to_host(cps, prune_budget=prune_budget)
    drs = ruleset_from_numpy(drs_np, dev)
    dsvc = svc_to_device(svc, dev)
    meta = PipelineMeta(
        match=match_meta,
        flow_slots=flow_slots,
        aff_slots=aff_slots,
        ct_timeout_s=ct_timeout_s,
        miss_chunk=miss_chunk,
        ct_syn_timeout_s=ct_syn_timeout_s,
        ct_other_new_s=ct_other_new_s,
        ct_other_est_s=ct_other_est_s,
        fused=fused,
        onepass=(bool(fused and prune_budget > 0) if onepass is None
                 else bool(onepass)),
    )
    state = init_state(flow_slots, aff_slots, device=dev)

    def step(state, drs, dsvc, src_f, dst_f, proto, sport, dport, now, gen,
             flags=None):
        return pipeline_step(state, drs, dsvc, src_f, dst_f, proto, sport,
                             dport, now, gen, meta=meta, flags=flags)

    step.meta = meta
    return step, state, (drs, dsvc)


def _service_lb(aff, dsvc, h, src_f, dst_f, proto, dport, now, aff_slots):
    """ServiceLB + affinity + endpoint choice for a (miss) sub-batch.

    -> (svc_idx, no_ep, dnat_ip_f, dnat_port, snat, dsr, learn)."""
    nu = dsvc.uip_f.shape[0]
    row = torch.searchsorted(dsvc.uip_f, dst_f).clamp(0, nu - 1)
    ip_is_svc = dsvc.uip_f[row] == dst_f
    key = (proto << 16) + dport
    slot_eq = dsvc.ppk[row] == key[:, None]  # (M, MAXP)
    slot_found = slot_eq.any(dim=1)
    # torch has no bool argmax; both frameworks return the first maximum.
    slot_col = slot_eq.to(_I32).argmax(dim=1)
    hit_lane = ip_is_svc & slot_found
    svc_idx = torch.where(hit_lane, dsvc.slot_svc[row, slot_col], MISS)
    snat_sel = torch.where(hit_lane, dsvc.slot_snat[row, slot_col], 0)

    is_svc = svc_idx >= 0
    svc_safe = svc_idx.clamp(0, dsvc.n_ep.shape[0] - 1).long()
    no_ep = is_svc & (dsvc.has_ep[svc_safe] == 0)

    # Session affinity (ClientIP, hard timeout) — the learn-flow analog.
    aff_on = is_svc & (dsvc.aff_timeout[svc_safe] > 0)
    ah = hashing.fnv_mix([_raw_bits(src_f), svc_safe])
    aslot = ah & (aff_slots - 1)
    a_ep = aff.ep[aslot]
    # Entry liveness = stored ep+1 > 0; a stored ep slot >= the service's
    # current endpoint count is stale (endpoints shrank) and re-selects.
    aff_hit = (
        aff_on
        & (a_ep > 0)
        & (a_ep - 1 < dsvc.n_ep[svc_safe])
        & (aff.key_client[aslot] == src_f)
        & (aff.key_svc[aslot] == svc_idx)
        & ((now - aff.ts[aslot]) <= dsvc.aff_timeout[svc_safe])
    )
    hash_ep = ((h & 0x7FFFFFFF) % dsvc.n_ep[svc_safe]).to(_I32)
    ep_col = torch.where(aff_hit, a_ep - 1, hash_ep)
    eidx = (dsvc.ep_base[svc_safe] + ep_col).clamp(
        0, dsvc.ep_ip_f.shape[0] - 1).long()

    use_ep = is_svc & ~no_ep
    dnat_ip = torch.where(use_ep, dsvc.ep_ip_f[eidx], dst_f)
    dnat_port = torch.where(use_ep, dsvc.ep_port[eidx], dport)
    # SNAT is a property of the matched FRONTEND, DSR of the PROGRAM.
    snat = torch.where(use_ep, snat_sel, 0)
    dsr = torch.where(use_ep, dsvc.prog_dsr[svc_safe], 0)
    learn = {
        "mask": aff_on & ~aff_hit & ~no_ep,
        "aslot": aslot,
        "client": src_f,
        "svc": svc_idx,
        "ep": ep_col + 1,  # stored +1: 0 means empty slot
    }
    return svc_idx, no_ep, dnat_ip, dnat_port, snat, dsr, learn


def _lb_phase(meta, aff, dsvc, h, src_f, dst_f, proto, dport, now):
    """_service_lb under PH_LB; with it masked, no service resolution: lanes
    keep their literal destination and nothing learns."""
    if meta.phases & PH_LB:
        return _service_lb(aff, dsvc, h, src_f, dst_f, proto, dport, now,
                           meta.aff_slots)
    z = torch.zeros_like(src_f)
    svc_idx = torch.full_like(src_f, MISS)
    learn = {"mask": torch.zeros_like(src_f, dtype=torch.bool),
             "aslot": torch.zeros_like(src_f, dtype=torch.int64),
             "client": src_f, "svc": svc_idx, "ep": z}
    return (svc_idx, torch.zeros_like(src_f, dtype=torch.bool), dst_f, dport,
            z, z, learn)


def _svc_ref_of(svc_idx, dsvc):
    """toServices probe identity: the lane's LB program mapped to its owning
    service index; MISS for non-service lanes."""
    p = dsvc.prog_svc.shape[0]
    return torch.where(svc_idx >= 0, dsvc.prog_svc[svc_idx.clamp(0, p - 1)],
                       MISS)


def entry_timeout(conf, proto, timeouts):
    """Per-entry idle timeout from the CONFIRMED bit + protocol."""
    t_syn, t_est, t_onew, t_oest = timeouts
    is_tcp = proto == PROTO_TCP
    return torch.where(
        is_tcp,
        torch.where(conf != 0, t_est, t_syn),
        torch.where(conf != 0, t_oest, t_onew),
    ).to(_I32)


def _cache_lookup(flow, slot, addr, pp, pg_cur, pg_est, now, proto, meta):
    """Fast-path flow-cache probe.  -> (hit, est, rpl, meta_row, key_row,
    ts_col), the rows gathered at batch start (copies: the one-pass kernel
    re-derives the probe from them after the step has written the cache)."""
    A = addr.shape[1]
    kr = flow.keys[slot]  # (B, A+2) row gather
    kpg = kr[:, A + 1]
    pg_rpl = pg_est | REPLY_BIT
    key_hit = (
        (kr[:, :A] == addr).all(dim=1)
        & (kr[:, A] == pp)
        & ((kpg == pg_cur) | (kpg == pg_est) | (kpg == pg_rpl))
    )
    mr = flow.meta[slot]
    ZC = _meta_cols(A)[3]
    tmo = meta.timeouts
    if tmo[0] == tmo[1] == tmo[2] == tmo[3]:
        timeout = tmo[1]
    else:
        timeout = entry_timeout((mr[:, ZC] >> 29) & 1, proto, tmo)
    ts = flow.ts[slot]
    hit = key_hit & ((now - ts) <= timeout)
    est = hit & ((kpg == pg_est) | (kpg == pg_rpl))
    rpl = hit & (kpg == pg_rpl)
    return hit, est, rpl, mr, kr, ts


def pipeline_step(
    state: PipelineState,
    drs: DeviceRuleSet,
    dsvc: DeviceServiceTables,
    src_f: torch.Tensor,
    dst_f: torch.Tensor,
    proto: torch.Tensor,
    sport: torch.Tensor,
    dport: torch.Tensor,
    now: int,
    gen: int,
    *,
    meta: PipelineMeta,
    flags: Optional[torch.Tensor] = None,
    hit_combine=None,
    valid=None,
    no_commit=None,
    v6=None,
):
    """One step, synchronous at meta.phases == PH_ALL; see the module
    docstring and PH_*.  hit_combine (rule-axis sharding), valid, no_commit
    and v6 are not ported."""
    _refuse(hit_combine=hit_combine is not None, valid=valid is not None,
            no_commit=no_commit is not None, v6=v6 is not None)
    if meta.onepass and meta.match.prune_budget <= 0:
        raise ValueError(
            "the one-kernel fast path (onepass) requires the narrow v4 "
            "key layout and an aggregate-pruned meta (prune_budget > 0)")
    flow, aff = state.flow, state.aff
    dev = src_f.device
    B = src_f.shape[0]
    N = meta.flow_slots
    M = meta.miss_chunk
    dump = N
    A = 2  # address columns (v4)
    DC, M1C, RC, ZC = _meta_cols(A)
    now = int(now)
    gen_w = int(gen) % GEN_ETERNAL  # never == GEN_ETERNAL

    src_raw = _raw_bits(src_f)
    dst_raw = _raw_bits(dst_f)
    pp = _pair16(sport, dport)

    # ---- fast path: flow-cache lookup ----
    addr = torch.stack([src_f, dst_f], dim=1)
    h = hashing.flow_hash(src_raw, dst_raw, proto, sport, dport)
    slot = h & (N - 1)
    pg_cur = proto | 0x100 | (gen_w << 9)
    pg_est = proto | 0x100 | (GEN_ETERNAL << 9)
    hit, est, rpl, mr, kr0, ts0 = _cache_lookup(
        flow, slot, addr, pp, pg_cur, pg_est, now, proto, meta)
    c_code, c_svc, c_dport = _unpack_meta1(mr[:, M1C])
    c_dnat_ip = mr[:, DC]
    c_rule_in, c_rule_out = _unpack_rules(mr[:, RC])

    # Idle-timeout refresh for hits (every duplicate writes the same value).
    flow.ts[torch.where(hit, slot, dump)] = now

    # Deferred partner refresh: conntrack refreshes both directions, so an
    # established hit whose partner stamp is older than ct_timeout/2 walks
    # to its partner entry (recomputed from the cached DNAT meta and
    # key-verified) and refreshes it.
    p_half = max(1, meta.ct_timeout_s // 2)
    pmask = PREF_MASK
    c_pref = mr[:, ZC] & pmask
    p_need = est & (((now - c_pref) & pmask) >= p_half)
    # SYN_SENT -> ESTABLISHED on the first reply-direction hit.
    conf_need = rpl & (((mr[:, ZC] >> 29) & 1) == 0)
    # TCP teardown: FIN or RST on an established entry removes both
    # directions after this packet's own verdict.
    td = (est & (proto == PROTO_TCP) & ((flags & _TEARDOWN_FLAGS) != 0)
          if flags is not None else torch.zeros_like(est))
    miss = ~hit
    # The step's one read-back: which conditional phases run, and the
    # miss count that sizes the round loop.
    any_p, any_c, any_t, n_miss = torch.stack([
        p_need.any().long(), conf_need.any().long(), td.any().long(),
        miss.sum()]).tolist()

    def partner_probe(keys, mask):
        """Each lane's partner tuple (the other direction of its hit
        entry), key-verified against `keys`.  -> (p_slot, live_mask)."""
        p_sport = torch.where(rpl, dport, c_dport)
        p_dport = torch.where(rpl, c_dport, sport)
        p_pg = torch.where(rpl, pg_est, pg_est | REPLY_BIT)
        p_src = torch.where(rpl, dst_f, c_dnat_ip)
        p_dst = torch.where(rpl, c_dnat_ip, src_f)
        p_h = hashing.flow_hash(_raw_bits(p_src), _raw_bits(p_dst), proto,
                                p_sport, p_dport)
        p_slot = p_h & (N - 1)
        pkr = keys[p_slot]
        live = (
            mask
            & (pkr[:, 0] == p_src) & (pkr[:, 1] == p_dst)
            & (pkr[:, A] == _pair16(p_sport, p_dport))
            & (pkr[:, A + 1] == p_pg)
        )
        return p_slot, live

    if any_p:
        p_slot, p_live = partner_probe(flow.keys, p_need)
        flow.ts[torch.where(p_live, p_slot, dump)] = now
        # Attempt-time stamp even when the partner is gone; the cached
        # snat/dsr/conf bits are preserved.
        flow.meta[torch.where(p_need, slot, dump), ZC] = (
            (now & pmask) | (mr[:, ZC] & ~pmask))

    if any_c:
        # OR into the CURRENT meta (the refresh above may have stamped it).
        m = flow.meta
        tgt0 = torch.where(conf_need, slot, dump)
        m[tgt0, ZC] = m[tgt0, ZC] | CONF_BIT
        c_slot, c_live = partner_probe(flow.keys, conf_need)
        tgt = torch.where(c_live, c_slot, dump)
        m[tgt, ZC] = m[tgt, ZC] | CONF_BIT

    if any_t:
        flow.keys[torch.where(td, slot, dump)] = 0
        t_slot, t_live = partner_probe(flow.keys, td)
        flow.keys[torch.where(t_live, t_slot, dump)] = 0

    # Output images, one column per output in B3's main-row order [code,
    # rule_in, rule_out, svc, dnat_ip_f, dnat_port, snat, dsr, committed],
    # plus a dump row for masked slow-path writes.  SNAT / DSR marks are
    # cached in meta3 bits 31 / 30 at commit time.  Miss lanes default to
    # meta.miss_code, the verdict they keep when the slow path is masked.
    zero = torch.zeros(B, dtype=_I32, device=dev)
    fwd_hit = hit & ~rpl
    img = torch.cat([torch.stack([
        torch.where(hit, c_code, meta.miss_code),
        torch.where(hit, c_rule_in, MISS),
        torch.where(hit, c_rule_out, MISS), torch.where(hit, c_svc, MISS),
        torch.where(hit, c_dnat_ip, dst_f), torch.where(hit, c_dport, dport),
        torch.where(fwd_hit, (mr[:, ZC] >> 31) & 1, 0),
        torch.where(fwd_hit, (mr[:, ZC] >> 30) & 1, 0), zero],
        dim=1).to(_I32), torch.zeros((1, 9), dtype=_I32, device=dev)])
    n_evict = n_reclaim = torch.zeros((), dtype=_I32, device=dev)
    prune_on = meta.match.prune_budget > 0
    # Prune counters: aggregate-AND skips, full-width fallbacks, and the
    # candidate-superblock histogram (_prune_bucket_counts layout).
    prune = (zero[0], zero[0],
             torch.zeros(len(PRUNE_HIST_BOUNDS) + 2, dtype=_I32, device=dev))

    # ---- slow path: ServiceLB + classify + commit, misses only ----
    # With PH_SLOW masked (the async fast step) misses keep the fast-path
    # image and nothing commits.
    slow = n_miss > 0 and bool(meta.phases & PH_SLOW)
    if slow and meta.onepass:
        fresh, n_evict, n_reclaim, prune = _slow_onepass(
            state, drs, dsvc, src_f, dst_f, proto, sport, dport, pp, h, slot,
            miss, mr, kr0, ts0, now, gen_w, meta)
        img[:B] = torch.where(miss[:, None], fresh, img[:B])
    elif slow:
        rounds = -(-n_miss // M)
        # Affinity lookups see the start-of-batch table in every round;
        # learns land in the live table.
        aff_snap = (aff if rounds == 1
                    else AffinityTable(*(t.clone() for t in aff)))
        midx = torch.cat([
            torch.nonzero(miss).flatten(),
            torch.full((rounds * M - n_miss,), B, dtype=torch.int64,
                       device=dev)])
        no_commit_m = torch.zeros(M, dtype=torch.bool, device=dev)
        for r in range(rounds):
            idx = midx[r * M:(r + 1) * M]
            valid_m = idx < B
            safe = idx.clamp(0, B - 1)
            s_f = src_f[safe]
            d_f = dst_f[safe]
            p_m = proto[safe]
            sp_m = sport[safe]
            dp_m = dport[safe]

            svc_idx, no_ep, dnat_ip, dnat_port, snat_m, dsr_m, learn = (
                _lb_phase(meta, aff_snap, dsvc, h[safe], s_f, d_f, p_m, dp_m,
                          now))
            # Lanes classify on their POST-DNAT tuple; PH_CLS_SUM alone runs
            # the pruned classifier's aggregate phase only.
            cls = None
            if meta.phases & PH_CLS or (prune_on
                                        and meta.phases & PH_CLS_SUM):
                cls = classify_batch(
                    drs, s_f, dnat_ip, p_m, dnat_port, meta=meta.match,
                    fused=meta.fused, svc_ref=_svc_ref_of(svc_idx, dsvc),
                    summary_only=not meta.phases & PH_CLS)
                # SvcReject happens before the policy tables: no
                # attribution.
                code = torch.where(no_ep, ACT_REJECT, cls["code"]).to(_I32)
                rule_in = torch.where(no_ep, MISS, cls["ingress_rule"])
                rule_out = torch.where(no_ep, MISS, cls["egress_rule"])
            else:
                # Classify masked: every lane default-allows (SvcReject
                # still applies: it is an LB decision).
                code = torch.where(no_ep, ACT_REJECT, ACT_ALLOW).to(_I32)
                rule_in = rule_out = torch.full_like(code, MISS)
            if prune_on and cls is not None:
                # Valid lanes only: padding lanes classify a copy of lane
                # B-1 and must not count.
                prune = (
                    prune[0] + (cls["prune_skip"] & valid_m).sum(dtype=_I32),
                    prune[1] + (cls["prune_fb"] & valid_m).sum(dtype=_I32),
                    prune[2] + _prune_bucket_counts(cls["prune_cand"],
                                                    valid_m))
            rows = _fused_pack_rows(
                s_f, d_f, p_m, sp_m, dp_m, pp[safe], code, svc_idx, dnat_ip,
                dnat_port, snat_m, dsr_m, rule_in, rule_out, valid_m,
                no_commit_m, now, gen_w, N, pmask)
            # Results into the output images (miss lanes are distinct;
            # padding lanes write the dump row).
            img[torch.where(valid_m, idx, B)] = torch.stack(
                [code, rule_in, rule_out, svc_idx, dnat_ip, dnat_port,
                 snat_m, dsr_m, rows["committed"]], dim=1).to(_I32)
            if meta.phases & PH_COMMIT:
                ev, rc = _commit(state, slot[safe], rows, learn,
                                 learn["mask"] & valid_m, now, gen_w, meta)
                n_evict, n_reclaim = n_evict + ev, n_reclaim + rc

    cols = img[:B].t().contiguous()
    out = {
        "code": cols[0],
        "est": est.to(_I32),
        # Reply-direction hit: dnat_ip_f/dnat_port carry the UN-DNAT
        # rewrite (the frontend the reply's source is restored to).
        "reply": rpl.to(_I32),
        "reject_kind": reject_kind_of(cols[0], proto),
        "svc_idx": cols[3],
        "dnat_ip_f": cols[4],
        "dnat_port": cols[5],
        "ingress_rule": cols[1],
        "egress_rule": cols[2],
        "committed": cols[8],
        # Per-lane cache-miss mask: with PH_SLOW masked, the async engine's
        # admission mask.
        "miss": miss.to(_I32),
        "snat": cols[6],
        "dsr": cols[7],
        "n_miss": torch.tensor(n_miss, dtype=_I32, device=dev),
        "n_evict": n_evict,
        # Overwrites of dead rows, split out of n_evict only under
        # meta.drain_reclaim; 0 otherwise.
        "n_reclaim": n_reclaim,
    }
    if prune_on:
        # Keys exist iff prune_budget > 0, as in the JAX step.
        out["n_prune_skips"], out["n_prune_fb"], out["prune_cand_hist"] = prune
    return state, out


def _commit(state, slot, rows, learn, learn_mask, now, gen_w, meta):
    """In place: commit a set of lanes' forward and reply rows
    (_fused_pack_rows output) interleaved per lane [fwd_i, rev_i], so
    last-writer-wins resolves collisions in per-lane insert order, and
    their affinity learns.  Under PH_EVICT the eviction census (an insert
    over a live entry whose tuple differs; a same-tuple rewrite is an
    update) reads each target's key row, and under meta.drain_reclaim also
    its CONFIRMED bit and ts, before the scatters.  An overwritten row that
    is already dead to lookups (idle past its per-state timeout, or a
    denial of another generation) counts as a reclaim, not an eviction.
    -> (evictions, reclaims), int32 scalars."""
    flow, aff = state.flow, state.aff
    dump = meta.flow_slots
    A = 2
    ZC = _meta_cols(A)[3]
    m = slot.shape[0]
    slot2 = torch.stack([slot, rows["rev_slot"].long()], dim=1).reshape(2 * m)
    keys2 = rows["keys8"].reshape(2 * m, 4)
    meta2 = rows["meta8"].reshape(2 * m, 4)
    ins2 = torch.stack([rows["ins"], rows["rev_ins"]], dim=1).reshape(2 * m)

    n_evict = n_reclaim = torch.zeros((), dtype=_I32, device=slot.device)
    if meta.phases & PH_EVICT:
        tgt2 = torch.where(ins2, slot2, dump)
        okr = flow.keys[tgt2]
        id3 = 0xFF | REPLY_BIT
        tuple_differs = (
            (okr[:, :A + 1] != keys2[:, :A + 1]).any(dim=1)
            | ((okr[:, A + 1] & id3) != (keys2[:, A + 1] & id3))
        )
        overwrote = ins2 & (okr[:, A + 1] != 0) & tuple_differs
        if meta.drain_reclaim:
            otmo = entry_timeout((flow.meta[tgt2, ZC] >> 29) & 1,
                                 okr[:, A + 1] & 0xFF, meta.timeouts)
            ogen = (okr[:, A + 1] >> 9) & GEN_ETERNAL
            dead = ((now - flow.ts[tgt2]) > otmo) | (
                (ogen != GEN_ETERNAL) & (ogen != gen_w))
            n_reclaim = (overwrote & dead).sum(dtype=_I32)
            overwrote = overwrote & ~dead
        n_evict = overwrote.sum(dtype=_I32)

    _scatter_last(flow.keys, slot2, keys2, ins2, dump)
    _scatter_last(flow.meta, slot2, meta2, ins2, dump)
    _scatter_last(flow.ts, slot2, torch.full((2 * m,), now, dtype=_I32,
                                             device=slot.device), ins2, dump)
    adump = meta.aff_slots
    _scatter_last(aff.key_client, learn["aslot"], learn["client"], learn_mask,
                  adump)
    _scatter_last(aff.key_svc, learn["aslot"], learn["svc"], learn_mask, adump)
    _scatter_last(aff.ep, learn["aslot"], learn["ep"], learn_mask, adump)
    _scatter_last(aff.ts, learn["aslot"],
                  torch.full((m,), now, dtype=_I32, device=slot.device),
                  learn_mask, adump)
    return n_evict, n_reclaim


def _onepass_probes(drs, dsvc, src_f, proto, svc_idx, dnat_ip, dnat_port,
                    miss, meta):
    """The one-pass path's classification probes on the post-DNAT tuple
    (pipeline.py:1684-1711): the miss-masked interval rows (hit lanes take
    row 0), the six aggregate rows (the svcref row ORed into egress svc)
    and the isolation bits.  -> (iv6, iv_ref, aggs, iso_in, iso_out)."""
    ing, eg = drs.ingress, drs.egress
    svc_key = (proto << 16) | dnat_port

    def midx(tab, x):
        return torch.where(miss, _dim_index(tab, x), 0).to(_I32)

    iv6 = [midx(ing.at, dnat_ip), midx(ing.peer, src_f),
           midx(ing.svc, svc_key), midx(eg.at, src_f), midx(eg.peer, dnat_ip),
           midx(eg.svc, svc_key)]
    iv_ref = (midx(eg.svc, _svcref_key(svc_key, _svc_ref_of(svc_idx, dsvc)))
              if meta.match.svcref else torch.zeros_like(src_f))
    aggs = [t.agg[i] for t, i in zip(
        (ing.at, ing.peer, ing.svc, eg.at, eg.peer, eg.svc), iv6)]
    if meta.match.svcref:
        aggs[5] = aggs[5] | eg.svc.agg[iv_ref]
    iso_in = drs.iso_in.val[midx(drs.iso_in, dnat_ip)]
    iso_out = drs.iso_out.val[midx(drs.iso_out, src_f)]
    return iv6, iv_ref, aggs, iso_in, iso_out


def _onepass_inputs(aff, drs, dsvc, src_f, dst_f, proto, sport, dport, pp, h,
                    miss, kr0, mr, ts0, now, meta, lb=None):
    """ServiceLB over the whole batch (under PH_LB) and B3's lane inputs
    (pipeline.py:1670-1859): the miss-masked interval rows, the six
    aggregate rows, the isolation bits.  kr0/mr/ts0 are the cache rows
    gathered at batch start; lb is _lb_phase's result when the caller has
    it.  -> (onepass.OnepassInputs, the affinity learn dict)."""
    if lb is None:
        lb = _lb_phase(meta, aff, dsvc, h, src_f, dst_f, proto, dport, now)
    svc_idx, no_ep, dnat_ip, dnat_port, snat_m, dsr_m, learn = lb
    iv6, iv_ref, aggs, iso_in, iso_out = _onepass_probes(
        drs, dsvc, src_f, proto, svc_idx, dnat_ip, dnat_port, miss, meta)
    z = torch.zeros_like(src_f)
    x = onepass.OnepassInputs(
        pkt=torch.stack([src_f, dst_f, proto, sport, dport, pp, z, z], dim=1),
        kr=kr0,
        prb=torch.stack([ts0, iso_in, iso_out, z], dim=1),
        mrow=mr,
        msk=torch.stack([torch.ones_like(z), z, z, z], dim=1),
        lb=torch.stack([svc_idx, no_ep.to(_I32), dnat_ip, dnat_port, snat_m,
                        dsr_m, z, z], dim=1),
        agg=tuple(aggs),
        iv=torch.stack([*iv6, iv_ref, z], dim=1),
    )
    return x, learn


def _fresh_code(drs, hits6, iso_in, iso_out, no_ep):
    """Hits -> the slow path's fresh verdict, SvcReject first.
    -> (code, rule_in, rule_out)."""
    in_code, in_rule = _resolve(drs.ingress.action, hits6[:3], iso_in)
    out_code, out_rule = _resolve(drs.egress.action, hits6[3:], iso_out)
    code = torch.where(no_ep, ACT_REJECT, torch.where(
        out_code != ACT_ALLOW, out_code, in_code)).to(_I32)
    return code, torch.where(no_ep, MISS, in_rule), torch.where(
        no_ep, MISS, out_rule)


def _slow_onepass(state, drs, dsvc, src_f, dst_f, proto, sport, dport, pp, h,
                  slot, miss, mr, kr0, ts0, now, gen_w, meta):
    """The one-pass slow path (pipeline.py:1638-2071, resolve variant).
    Under PH_CLS: B3 over the whole batch, the full-width re-walk of its
    fallback lanes (through B1) and the prune counters.  Without it B3 does
    not run: under PH_CLS_SUM the aggregate AND alone gives the skip and
    candidate counts of the miss lanes and every live lane the
    default-verdict image; with neither bit every lane default-allows.
    Then, under PH_COMMIT, one interleaved commit of every lane's rows.
    -> (the miss lanes' images (B, 9), evictions, reclaims, (skips,
    fallbacks, candidate histogram))."""
    ing, eg = drs.ingress, drs.egress
    mm = meta.match
    N = meta.flow_slots
    lb = _lb_phase(meta, state.aff, dsvc, h, src_f, dst_f, proto, dport, now)
    svc_idx, no_ep, dnat_ip, dnat_port, snat_m, dsr_m, learn = lb
    zero = torch.zeros((), dtype=_I32, device=src_f.device)
    if meta.phases & PH_CLS:
        x, _ = _onepass_inputs(state.aff, drs, dsvc, src_f, dst_f, proto,
                               sport, dport, pp, h, miss, kr0, mr, ts0, now,
                               meta, lb=lb)
        tabs = onepass.OnepassTables(
            inc=tuple(t.inc for t in (ing.at, ing.peer, ing.svc, eg.at,
                                      eg.peer, eg.svc)),
            act_in=ing.action, act_out=eg.action)
        st = onepass.OnepassStatic(
            k=mm.prune_budget, in_phases=mm.in_phases,
            out_phases=mm.out_phases, svcref=mm.svcref,
            timeouts=meta.timeouts, n_slots=N, pref_mask=PREF_MASK)
        main, keys8, meta8, aux = onepass.onepass(x, tabs, now, gen_w, st)

        fb = torch.nonzero(aux[:, 1]).flatten()
        if fb.numel():
            # Lanes with more than K candidate superblocks: the exact
            # full-width walk (the function B1 computes, so through B1's
            # wrapper), resolved and packed again, written back lane for
            # lane.
            iv = x.iv[fb].long()
            out_svc = eg.svc.inc[iv[:, 5]]
            if mm.svcref:
                out_svc = out_svc | eg.svc.inc[iv[:, 6]]
            hits = consumer.fused_hits(
                (ing.at.inc[iv[:, 0]], ing.peer.inc[iv[:, 1]],
                 ing.svc.inc[iv[:, 2]]),
                (eg.at.inc[iv[:, 3]], eg.peer.inc[iv[:, 4]], out_svc),
                mm.in_phases, mm.out_phases)
            lb_f, prb, pkt = x.lb[fb], x.prb[fb], x.pkt[fb]
            no_ep_f = lb_f[:, 1] != 0
            f_code, f_ri, f_ro = _fresh_code(drs, hits[:, :6].unbind(1),
                                             prb[:, 1], prb[:, 2], no_ep_f)
            fix = _fused_pack_rows(
                *pkt[:, :6].unbind(1), f_code, lb_f[:, 0], lb_f[:, 2],
                lb_f[:, 3], lb_f[:, 4], lb_f[:, 5], f_ri, f_ro, miss[fb],
                torch.zeros_like(no_ep_f), now, gen_w, N, PREF_MASK)
            main[fb, 0] = f_code
            main[fb, 1] = f_ri
            main[fb, 2] = f_ro
            main[fb, 8] = fix["committed"].to(_I32)
            main[fb, 9] = fix["rev_ins"].to(_I32)
            keys8[fb] = fix["keys8"]
            meta8[fb] = fix["meta8"]

        prune = ((aux[:, 0] != 0).sum(dtype=_I32),
                 (aux[:, 1] != 0).sum(dtype=_I32),
                 _prune_bucket_counts(aux[:, 2], miss))
        rows = dict(rev_slot=main[:, 10], keys8=keys8, meta8=meta8,
                    ins=main[:, 14] != 0, rev_ins=main[:, 9] != 0)
        fresh = main[:, :9]
    else:
        if meta.phases & PH_CLS_SUM:
            # The aggregate AND and short circuit only, over the miss lanes:
            # live lanes take the default-verdict image.
            _, _, aggs, iso_in, iso_out = _onepass_probes(
                drs, dsvc, src_f, proto, svc_idx, dnat_ip, dnat_port, miss,
                meta)
            nc = [torch.where(miss, ((a & p & s) != 0).sum(
                dim=1, dtype=_I32), 0)
                for a, p, s in (aggs[:3], aggs[3:])]
            cand = torch.maximum(nc[0], nc[1])
            bigs = torch.full_like(src_f, BIG)
            f_code, f_ri, f_ro = _fresh_code(drs, (bigs,) * 6, iso_in,
                                             iso_out, no_ep)
            prune = ((miss & (cand == 0)).sum(dtype=_I32), zero,
                     _prune_bucket_counts(cand, miss))
        else:
            # Neither classify bit: the staged default-allow image.
            f_code = torch.where(no_ep, ACT_REJECT, ACT_ALLOW).to(_I32)
            f_ri = f_ro = torch.full_like(f_code, MISS)
            prune = (zero, zero, torch.zeros(len(PRUNE_HIST_BOUNDS) + 2,
                                             dtype=_I32, device=zero.device))
        rows = _fused_pack_rows(
            src_f, dst_f, proto, sport, dport, pp, f_code, svc_idx, dnat_ip,
            dnat_port, snat_m, dsr_m, f_ri, f_ro, miss,
            torch.zeros_like(miss), now, gen_w, N, PREF_MASK)
        fresh = torch.stack([f_code, f_ri, f_ro, svc_idx, dnat_ip, dnat_port,
                             snat_m, dsr_m, rows["committed"]], dim=1).to(_I32)

    n_evict = n_reclaim = zero
    if meta.phases & PH_COMMIT:
        n_evict, n_reclaim = _commit(state, slot, rows, learn,
                                     learn["mask"] & miss, now, gen_w, meta)
    return fresh, n_evict, n_reclaim, prune


# ---- off-step maintenance scans (the async engine's epoch plane) ----------
# Whole-table elementwise passes, in place like the step.  Each clears only
# rows already dead to lookups, so none changes a verdict: it turns a later
# insert over the row from an eviction into plain occupancy.


def _live_rows(keys: torch.Tensor) -> torch.Tensor:
    """Occupied-entry mask over the (N+1,) row space, the dump row (index
    N) excluded."""
    kpg = keys[:, -1]
    n = kpg.shape[0]
    return (kpg != 0) & (torch.arange(n, device=keys.device) < n - 1)


def _expired_rows(flow: FlowCache, now: int, timeouts) -> torch.Tensor:
    """Live rows idle past their per-state conntrack lifetime."""
    kpg = flow.keys[:, -1]
    conf = (flow.meta[:, _meta_cols(flow.keys.shape[1] - 2)[3]] >> 29) & 1
    tmo = entry_timeout(conf, kpg & 0xFF, timeouts)
    return _live_rows(flow.keys) & ((int(now) - flow.ts) > tmo)


def _stale_rows(flow: FlowCache, gen: int) -> torch.Tensor:
    """Live denial rows whose generation is not the current one (committed,
    ETERNAL rows, reply legs included, are never stale)."""
    egen = (flow.keys[:, -1] >> 9) & GEN_ETERNAL
    gen_w = int(gen) % GEN_ETERNAL
    return _live_rows(flow.keys) & (egen != GEN_ETERNAL) & (egen != gen_w)


def _age_scan(state: PipelineState, now: int, *, timeouts):
    """Clear entries idle past their per-state lifetime (pipeline.py:2215).
    -> (state, n_reclaimed int32)."""
    expired = _expired_rows(state.flow, now, timeouts)
    state.flow.keys.masked_fill_(expired[:, None], 0)
    return state, expired.sum(dtype=_I32)


def _revalidate_scan(state: PipelineState, gen: int):
    """Clear denial entries of another generation (pipeline.py:2243).
    -> (state, n_cleared int32)."""
    stale = _stale_rows(state.flow, gen)
    state.flow.keys.masked_fill_(stale[:, None], 0)
    return state, stale.sum(dtype=_I32)


def _maintain_scan(state: PipelineState, now: int, gen: int, *, timeouts):
    """Both scans in one pass (pipeline.py:2270); a row both expired and
    stale counts as aged.  -> (state, n_aged, n_revalidated)."""
    expired = _expired_rows(state.flow, now, timeouts)
    stale = _stale_rows(state.flow, gen) & ~expired
    state.flow.keys.masked_fill_((expired | stale)[:, None], 0)
    return state, expired.sum(dtype=_I32), stale.sum(dtype=_I32)


def clone_state(state: PipelineState) -> PipelineState:
    """A copy of the state (the step updates its state in place)."""
    return PipelineState(flow=FlowCache(*(t.clone() for t in state.flow)),
                         aff=AffinityTable(*(t.clone() for t in state.aff)))


def copy_state_(dst: PipelineState, src: PipelineState) -> PipelineState:
    """In place: overwrite dst's tensors with src's.  -> dst."""
    for d, s in zip((*dst.flow, *dst.aff), (*src.flow, *src.aff)):
        d.copy_(s)
    return dst
