"""The datapath pipeline step: the PyTorch port of
antrea_tpu/models/pipeline.py, staged or one-pass over narrow (v4) keys and
staged over wide (dual-stack) keys, with the phase-mask surface the async engine's fast and drain steps and the
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

Dual-stack pipelines (make_pipeline(dual_stack=True), PipelineMeta
.key_words == 10) key the cache on both endpoints' 4-word addresses (v4
lanes in v4-mapped form, _wide_words), hash them with flow_hash_wide, store
the 4-word DNAT resolution in the meta row, key affinity on the 4-word
client and run the v6 frontend lookup; the step then also outputs the wide
DNAT view dnat_w_f.  The one-pass slow path stays v4-only.

All tensors are int32 words; u32 quantities keep their bits in int32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..apis.controlplane import PROTO_TCP
from ..compiler.compile import ACT_ALLOW, ACT_REJECT, CompiledPolicySet
from ..compiler.services import ServiceTables
from ..observability import tracing
from ..ops import hashing, onepass
from ..ops.match import (BIG, PRUNE_HIST_BOUNDS, DeviceRuleSet, StaticMeta,
                         _delta_matches, _patch_agg, _patch_iso, _resolve,
                         _searchsorted6, classify_batch, delta_overlay,
                         from_numpy, resolve_device, rewalk_hits,
                         ruleset_from_numpy, shard_offsets, to_host)

# Every device->host sync of this module's functions, "function" or
# "Class.method" -> why it is there.  A pure literal: the analysis plane's
# host-sync pass holds it against the module's explicit sync calls, and
# chip_smoke.py's sync census against the syncs the card reports.  Rows
# for syncs no AST sees start with "implicit:".
HOST_SYNCS = {
    "pipeline_step": "the step's read-back of which conditional phases run "
                     "and the miss count that sizes the round loop; the "
                     "staged rounds' miss-lane compaction (nonzero) sizes "
                     "their gathers; two uploads of host ints (the hits' "
                     "idle-refresh stamp written by index, the n_miss "
                     "output)",
    "_slow_onepass": "the one-pass fallback lanes (nonzero of B3's flag "
                     "column) size the B1 re-walk's gather",
    "_delta_fixup": "the miss lanes a pending delta covers (nonzero) size "
                    "their overlay",
    "tensor_digest": "the scrub digest is a host int: one read-back for all "
                     "leaves, off the step",
    "_prune_bucket_counts": "implicit: the histogram's bucket bounds are "
                            "uploaded from a host tuple on every call",
}

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

# Second chance (PipelineMeta.second_chance): a 2-bit saturating collision
# counter in meta3 bits 27-28.  A live, CONFIRMED established entry
# survives a colliding insert while its counter is below CHANCE_MAX (the
# challenger stays uncached), the counter bumps once per commit pass and
# the entry's own next hit resets it.  With the knob on the partner-refresh
# stamp narrows to bits 0-26.
CHANCE_SHIFT = 27
CHANCE_MAX = 3
CHANCE_MASK = CHANCE_MAX << CHANCE_SHIFT
PREF_MASK_CHANCE = (1 << CHANCE_SHIFT) - 1

# REJECT synthesis kinds: TCP gets an RST, everything else an ICMP
# port-unreachable.
REJECT_NONE = 0
REJECT_TCP_RST = 1
REJECT_ICMP_UNREACH = 2

# TCP wire flag bits consumed by conntrack teardown.
TCP_FIN = 0x01
TCP_RST = 0x04
_TEARDOWN_FLAGS = TCP_FIN | TCP_RST

# tel_dma_hb counts the half-blocks the JAX package's one-pass kernel walks
# for a batch (ops/match.py _FUSE_TB, _OP_HB there): its TPU schedule's DMA
# granules, a constant of the batch shape, kept so that the counter equals
# the JAX engine's.  It is not work done by B3's CUDA kernel.
TEL_TILE = 128
TEL_HALF_BLOCK = 64

INT32_MIN = -(2**31)


def no_commit_mask(dst, proto, flags, xp=np):
    """Never-cacheable lanes of a v4 miss batch (host columns): multicast
    destinations and FIN/RST-flagged TCP misses.  The drain's commit
    gating, the host twin of the full walk's own."""
    return ((xp.asarray(dst) >> 28) == 0xE) | (
        (xp.asarray(proto) == PROTO_TCP)
        & ((xp.asarray(flags) & _TEARDOWN_FLAGS) != 0)
    )

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

# The Service LB's counters of a step (PipelineMeta.lb_stats), in the order
# of the step's lb_stats output.  Over the lanes that take the LB's answer
# (the step's classified misses): those resolved to a Service, those of a
# Service with ClientIP affinity, those a live pin decided, and those
# rejected for want of endpoints; then the pins the commit wrote (each
# slot's winning learn once) and those of them that overwrote a live pin
# (younger than its Service's timeout) of another (client, Service) key.
LB_STATS = ("lb", "lb_aff", "aff_hit", "no_ep", "aff_learn",
            "aff_overwrite")

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
        (bit 31 of the last word: REPLY_BIT); dual-stack (N+1, 10):
        [s0..s3, d0..d3, pp, pg], the addresses in wide word form
      meta (N+1, 4) int32: [dnat_ip_f, meta1, rules, snat<<31|dsr<<30|conf<<29|pref]
        meta1 = code(2) | (svc_idx+1)(14) | dnat_port(16)
        rules = (rule_in+1)(16) | (rule_out+1)(16)
        dual-stack (N+1, 8): [dn_w0..dn_w3, meta1, rules, z, 0] (_meta_cols)
      ts (N+1,) int32: last-seen seconds
      pkts/octets/pkts_hi/octets_hi (N+1,) int32: per-direction packet and
        byte counters under PipelineMeta.count_flow_stats, each a 64-bit
        count in two limbs (the low limb's u32 bits, then the carry).
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

    key_client: torch.Tensor  # (M+1,) sign-flipped client ip; (M+1, 4)
    # wide words in dual-stack pipelines
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
    # The v6 frontend sub-table (sorted lexicographically, unique rows) and
    # every endpoint's wide words; (0, ...) shapes without v6 frontends.
    uip6_w: torch.Tensor  # (NU6, 4) per-word sign-flipped
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
    # Active slots of drs.ip_delta (the engine's pending membership deltas,
    # a host int: the step never reads the count back from the device).
    delta_n: int = 0
    # Per-entry packet and byte counters (FlowCache.pkts/octets, two int32
    # limbs each): the engine's FlowExporter gate.
    count_flow_stats: bool = False
    # Thrash-resistant replacement (CHANCE_SHIFT above).
    second_chance: bool = False
    # Hot-path telemetry: the tel_* counter outputs.
    telemetry: bool = False
    # Flow-cache key row width: 4 (v4: [src, dst, pp, pg]) or 10
    # (dual-stack: [s0..s3, d0..d3, pp, pg]).
    key_words: int = 4
    # The Service LB's counters (LB_STATS): the lb_stats output.
    lb_stats: bool = False

    @property
    def pref_mask(self) -> int:
        """The partner-refresh stamp's mask: second chance narrows it."""
        return PREF_MASK_CHANCE if self.second_chance else PREF_MASK

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
               device=None, key_words: int = 4) -> PipelineState:
    """An empty state; key_words=10 is the dual-stack layout (wide keys,
    8-column meta rows, 4-word affinity clients)."""
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    wide = key_words > 4
    n = flow_slots + 1
    flow = FlowCache(keys=zeros(n, key_words), meta=zeros(n, 8 if wide else 4),
                     ts=zeros(n), pkts=zeros(n), octets=zeros(n),
                     pkts_hi=zeros(n), octets_hi=zeros(n))
    m = aff_slots + 1
    aff = AffinityTable(key_client=zeros(m, 4) if wide else zeros(m),
                        key_svc=zeros(m), ep=zeros(m), ts=zeros(m))
    return PipelineState(flow=flow, aff=aff)


def _meta_cols(A: int) -> tuple[int, int, int, int]:
    """Meta-row column indices (dn_narrow, meta1, rules, zcol) for an
    address width A (key_words - 2): narrow [dnat_ip, m1, rules, z], wide
    [w0..w3, m1, rules, z, 0], whose narrow dnat view is word 3."""
    return (0, 1, 2, 3) if A == 2 else (3, 4, 5, 6)


def _raw_bits(x_f: torch.Tensor) -> torch.Tensor:
    """Sign-flipped int32 -> int32 whose u32 reinterpretation is the raw
    value."""
    return x_f ^ -(2**31)


# The RFC 4291 v4-mapped words in flipped lane space: flip(0), flip(0xffff).
_MAP0 = -(2**31)
_MAPF = -(2**31) + 0xFFFF


def _wide_words(col_f: torch.Tensor, w6, is6) -> torch.Tensor:
    """(B,) flipped v4 column, optional (B, 4) flipped v6 words and the
    family mask -> (B, 4) wide address words, v4 lanes in v4-mapped form
    (pipeline.py:461).  The one wide projection: every wide key (the probe,
    the reverse commit, the partner probe, the trace) goes through it."""
    m = torch.stack([torch.full_like(col_f, _MAP0),
                     torch.full_like(col_f, _MAP0),
                     torch.full_like(col_f, _MAPF), col_f], dim=1)
    if w6 is None:
        return m
    return torch.where((is6 != 0)[:, None], w6, m)


def _wide_lanes(src_f, dst_f, v6):
    """The step's wide lane view: v6 = (src6w, dst6w, is6) or None (every
    lane v4) -> (saddr, daddr, is6)."""
    if v6 is not None:
        src6w, dst6w, is6 = v6
    else:
        src6w = dst6w = None
        is6 = torch.zeros_like(src_f)
    return (_wide_words(src_f, src6w, is6), _wide_words(dst_f, dst6w, is6),
            is6)


def _wide_hash(saddr, daddr, proto, sport, dport):
    """flow_hash_wide of two (M, 4) address word blocks."""
    return hashing.flow_hash_wide([*saddr.unbind(1), *daddr.unbind(1)],
                                  proto, sport, dport)


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


def _below_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b on the u32 reinterpretation of int32 words (torch's CPU uint32
    has no <): flipping the sign bit maps u32 order onto int32 order."""
    return (a ^ INT32_MIN) < (b ^ INT32_MIN)


def _count_hits(flow: FlowCache, slot, hit, lens, dump):
    """In place, under meta.count_flow_stats: every hit adds one packet and
    its length (lens, (B,) or None for 0; negative lengths count 0) to its
    entry's counters (pipeline.py:1033-1058).  The low limb adds with a
    wrapping index_add_ (duplicate slots sum); a low limb whose u32 value
    shrank wrapped exactly once, and one lane per slot carries it into the
    high limb: exact while one entry takes < 2**32 bytes in one batch."""
    ctgt = torch.where(hit, slot, dump)
    cwin = _winner_mask(dump, slot, hit, dump)
    ones = torch.ones_like(slot, dtype=_I32)
    lv = torch.zeros_like(ones) if lens is None else lens.clamp_min(0)
    for lo, hi, add in ((flow.pkts, flow.pkts_hi, ones),
                        (flow.octets, flow.octets_hi, lv)):
        old = lo[ctgt]
        lo.index_add_(0, ctgt, add)
        carried = _below_u32(lo[ctgt], old)
        hi.index_add_(0, torch.where(cwin & carried, ctgt, dump), ones)


def _second_chance_guard(flow: FlowCache, slot2, keys2, ins2, now: int,
                         meta, dump):
    """In place, under meta.second_chance (pipeline.py:499-553): inserts
    whose target is a live, CONFIRMED, ETERNAL entry of another tuple with
    its collision counter below CHANCE_MAX are suppressed (the challenger
    stays uncached), and that entry's counter bumps once per commit pass.
    As in the JAX package, the staged rounds run one pass per round.
    -> (ins2 without the suppressed inserts, their count (int32) under
    meta.telemetry, else None)."""
    A = keys2.shape[1] - 2
    ZC = _meta_cols(A)[3]
    tgt2 = torch.where(ins2, slot2, dump)
    okr = flow.keys[tgt2]
    om3 = flow.meta[tgt2, ZC]
    id3 = 0xFF | REPLY_BIT
    tuple_differs = (
        (okr[:, :A + 1] != keys2[:, :A + 1]).any(dim=1)
        | ((okr[:, A + 1] & id3) != (keys2[:, A + 1] & id3)))
    ogen = (okr[:, A + 1] >> 9) & GEN_ETERNAL
    otmo = entry_timeout((om3 >> 29) & 1, okr[:, A + 1] & 0xFF,
                         meta.timeouts)
    protected = (
        ins2 & (okr[:, A + 1] != 0) & tuple_differs
        & (ogen == GEN_ETERNAL) & (((om3 >> 29) & 1) != 0)
        & ((now - flow.ts[tgt2]) <= otmo)
        & (((om3 >> CHANCE_SHIFT) & CHANCE_MAX) < CHANCE_MAX))
    n_protected = (protected.sum(dtype=_I32) if meta.telemetry else None)
    win = _winner_mask(dump, slot2, protected, dump)
    bt = torch.where(win, slot2, dump)
    cur = flow.meta[bt, ZC]
    newc = (((cur >> CHANCE_SHIFT) & CHANCE_MAX) + 1).clamp_max(CHANCE_MAX)
    flow.meta[bt, ZC] = (cur & ~CHANCE_MASK) | (newc << CHANCE_SHIFT)
    return ins2 & ~protected, n_protected


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
                     nc_m, now, gen_w, n_slots, pmask, wide=None):
    """The commit rows of a set of lanes: the forward entry, and the
    reply-direction entry keyed on the post-DNAT tuple with ports swapped,
    whose meta carries the un-DNAT rewrite; ALLOW entries as ETERNAL
    (conntrack), denials tagged with the generation; DSR lanes commit no
    reply leg.  The torch twin of B3's packing (pipeline.py:579).
    -> dict(committed, ins, rev_ins, rev_slot, keys8 (M, 8), meta8 (M, 8)):
    each row the forward then the reply entry.

    wide = (saddr, daddr, dnat_w), each (M, 4): the dual-stack rows of the
    staged commit (pipeline.py:1450-1520), keys8 (M, 20) and meta8
    (M, 16): keys on the wide words, meta [dnat_w, m1, rules, z, 0]
    forward and [daddr, m1, rules, pref, 0] reply, the reply slot hashed
    with flow_hash_wide."""
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
    rev_pg = proto | 0x100 | (GEN_ETERNAL << 9) | REPLY_BIT
    rev_pp = _pair16(dnat_port, sport)
    rev_m1 = _pack_meta1(f_code, svc_idx, dport)
    if wide is None:
        rev_h = hashing.flow_hash(_raw_bits(dnat_ip), _raw_bits(src_f), proto,
                                  dnat_port, sport)
        keys8 = torch.stack([src_f, dst_f, pp, pg_ins, dnat_ip, src_f,
                             rev_pp, rev_pg], dim=1)
        meta8 = torch.stack([dnat_ip, m1, rules_p, zcol, dst_f, rev_m1,
                             rules_p, pref_col], dim=1)
    else:
        saddr, daddr, dnat_w = wide
        rev_h = _wide_hash(dnat_w, saddr, proto, dnat_port, sport)
        z = torch.zeros_like(proto)
        keys8 = torch.cat([saddr, daddr, torch.stack([pp, pg_ins], dim=1),
                           dnat_w, saddr, torch.stack([rev_pp, rev_pg], dim=1)],
                          dim=1)
        meta8 = torch.cat([dnat_w, torch.stack([m1, rules_p, zcol, z], dim=1),
                           daddr, torch.stack([rev_m1, rules_p, pref_col, z],
                                              dim=1)], dim=1)
    rev_slot = (rev_h & (n_slots - 1)).to(_I32)
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
    flags=None, lens=None, v6=None) -> (state', out dict); state' is
    `state`, updated in place.
    drs/dsvc are explicit arguments so a rule-set swap is a call with new
    tensors and a bumped gen.  now and gen are ints (seconds, generation);
    the lane inputs are (B,) int32 tensors on the tables' device.

    device None means the card (raises without CUDA); "cpu" runs every
    kernel's plain version.  prune_budget > 0 builds the aggregate tables:
    misses then classify through the pruned walk, and fused=True upgrades
    the slow path to the one-pass kernel unless onepass=False pins the
    staged rounds (onepass=True demands it).  count_flow_stats,
    second_chance and telemetry set the PipelineMeta knobs of the same
    names (step then takes lens, the lanes' byte lengths, for the
    counters).  dual_stack=True selects the wide (10-word) key layout: the
    step then takes v6 = (src6w_f, dst6w_f, is6) lanes, and fused with
    prune_budget keeps the staged pruned rounds (the one-pass step is
    v4-only; onepass=True raises ValueError at the first step).
    """
    dev = resolve_device(device)
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
        onepass=(bool(fused and prune_budget > 0 and not dual_stack)
                 if onepass is None else bool(onepass)),
        count_flow_stats=count_flow_stats,
        second_chance=second_chance,
        telemetry=telemetry,
        key_words=10 if dual_stack else 4,
    )
    state = init_state(flow_slots, aff_slots, device=dev,
                       key_words=meta.key_words)

    def step(state, drs, dsvc, src_f, dst_f, proto, sport, dport, now, gen,
             flags=None, lens=None, v6=None):
        return pipeline_step(state, drs, dsvc, src_f, dst_f, proto, sport,
                             dport, now, gen, meta=meta, flags=flags,
                             lens=lens, v6=v6)

    step.meta = meta
    return step, state, (drs, dsvc)


def _frontend6(uip6_w: torch.Tensor, daddr: torch.Tensor):
    """The v6 frontend probe: (row, hit) per lane of daddr (M, 4) in the
    sorted, unique rows of uip6_w (NU6 > 0).  A search for the last row <=
    the lane and one equality test; the JAX package compares every lane
    with every row (pipeline.py:760-776), which gives the same row wherever
    a row is equal."""
    pos = _searchsorted6(uip6_w, daddr)
    row = (pos - 1).clamp(min=0)
    return row, (pos > 0) & (uip6_w[row] == daddr).all(dim=1)


def _service_lb(aff, dsvc, h, src_f, dst_f, proto, dport, now, aff_slots,
                wide=None):
    """ServiceLB + affinity + endpoint choice for a (miss) sub-batch.

    wide = (saddr, daddr, is6), the lanes' 4-word addresses (dual-stack
    pipelines): v4 lanes probe the narrow frontend table as in a v4
    pipeline, v6 lanes the v6 sub-table (_frontend6); affinity hashes and
    matches the 4-word client, and a v6 service lane's DNAT resolution is
    its endpoint's wide row.

    -> (svc_idx, no_ep, dnat_ip_f, dnat_port, snat, dsr, dnat_w, learn);
    dnat_w is the wide post-DNAT dst, (M, 4), None without `wide`."""
    saddr = daddr = is6 = None
    if wide is not None:
        saddr, daddr, is6 = wide
    nu = dsvc.uip_f.shape[0]
    row = torch.searchsorted(dsvc.uip_f, dst_f).clamp(0, nu - 1)
    ip_is_svc = dsvc.uip_f[row] == dst_f
    key = (proto << 16) + dport
    slot_eq = dsvc.ppk[row] == key[:, None]  # (M, MAXP)
    slot_found = slot_eq.any(dim=1)
    # torch has no bool argmax; both frameworks return the first maximum.
    slot_col = slot_eq.to(_I32).argmax(dim=1)
    hit_lane = ip_is_svc & slot_found
    if is6 is not None:
        # A v6 lane's narrow dst column is a don't-care: never a frontend.
        hit_lane = hit_lane & (is6 == 0)
    svc_idx = torch.where(hit_lane, dsvc.slot_svc[row, slot_col], MISS)
    snat_sel = torch.where(hit_lane, dsvc.slot_snat[row, slot_col], 0)
    if is6 is not None and dsvc.uip6_w.shape[0] > 0:
        row6, ip6_hit = _frontend6(dsvc.uip6_w, daddr)
        slot_eq6 = dsvc.ppk6[row6] == key[:, None]
        hit6 = (is6 != 0) & ip6_hit & slot_eq6.any(dim=1)
        col6 = slot_eq6.to(_I32).argmax(dim=1)
        svc_idx = torch.where(hit6, dsvc.slot_svc6[row6, col6], svc_idx)
        snat_sel = torch.where(hit6, dsvc.slot_snat6[row6, col6], snat_sel)

    is_svc = svc_idx >= 0
    svc_safe = svc_idx.clamp(0, dsvc.n_ep.shape[0] - 1).long()
    no_ep = is_svc & (dsvc.has_ep[svc_safe] == 0)

    # Session affinity (ClientIP, hard timeout) — the learn-flow analog;
    # wide pipelines hash and match the client's 4 words.
    aff_on = is_svc & (dsvc.aff_timeout[svc_safe] > 0)
    if saddr is None:
        ah = hashing.fnv_mix([_raw_bits(src_f), svc_safe])
        client_match = aff.key_client[ah & (aff_slots - 1)] == src_f
    else:
        ah = hashing.fnv_mix([_raw_bits(saddr[:, i]) for i in range(4)]
                             + [svc_safe])
        client_match = (aff.key_client[ah & (aff_slots - 1)]
                        == saddr).all(dim=1)
    aslot = ah & (aff_slots - 1)
    a_ep = aff.ep[aslot]
    # Entry liveness = stored ep+1 > 0; a stored ep slot >= the service's
    # current endpoint count is stale (endpoints shrank) and re-selects.
    aff_hit = (
        aff_on
        & (a_ep > 0)
        & (a_ep - 1 < dsvc.n_ep[svc_safe])
        & client_match
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
    dnat_w = None
    if saddr is not None:
        # v4 lanes map their narrow resolution, v6 service lanes take the
        # endpoint's wide row, other v6 lanes keep their literal words.
        dnat_w = torch.where((use_ep & (is6 != 0))[:, None],
                             dsvc.ep_ipw_f[eidx],
                             _wide_words(dnat_ip, daddr, is6))
    # SNAT is a property of the matched FRONTEND, DSR of the PROGRAM.
    snat = torch.where(use_ep, snat_sel, 0)
    dsr = torch.where(use_ep, dsvc.prog_dsr[svc_safe], 0)
    learn = {
        "mask": aff_on & ~aff_hit & ~no_ep,
        "aslot": aslot,
        "client": src_f if saddr is None else saddr,
        "svc": svc_idx,
        "ep": ep_col + 1,  # stored +1: 0 means empty slot
        # Affinity consulted, and a live pin taken (the LB's counters).
        "on": aff_on,
        "hit": aff_hit,
    }
    return svc_idx, no_ep, dnat_ip, dnat_port, snat, dsr, dnat_w, learn


def _lb_phase(meta, aff, dsvc, h, src_f, dst_f, proto, dport, now,
              wide=None):
    """_service_lb under PH_LB, in the walk.lb span; with it masked, no
    service resolution: lanes keep their literal destination (and words)
    and nothing learns."""
    sp = tracing.SLOT.sp
    if sp is not None:
        sp.enter("walk.lb")
    if meta.phases & PH_LB:
        lb = _service_lb(aff, dsvc, h, src_f, dst_f, proto, dport, now,
                         meta.aff_slots, wide=wide)
    else:
        z = torch.zeros_like(src_f)
        svc_idx = torch.full_like(src_f, MISS)
        no = torch.zeros_like(src_f, dtype=torch.bool)
        learn = {"mask": no,
                 "aslot": torch.zeros_like(src_f, dtype=torch.int64),
                 "client": src_f if wide is None else wide[0],
                 "svc": svc_idx, "ep": z, "on": no, "hit": no}
        lb = (svc_idx, torch.zeros_like(src_f, dtype=torch.bool), dst_f,
              dport, z, z, None if wide is None else wide[1], learn)
    if sp is not None:
        sp.leave()
    return lb


def _lb_counts(lb, lanes):
    """The LB's lane counters (LB_STATS[:4]) of _lb_phase's result over
    the lanes that take its answer, (4,) int32."""
    svc_idx, no_ep, *_, learn = lb
    return (torch.stack([svc_idx >= 0, learn["on"], learn["hit"], no_ep])
            & lanes).sum(dim=1, dtype=_I32)


def _svc_ref_of(svc_idx, dsvc):
    """toServices probe identity: the lane's LB program mapped to its owning
    service index; MISS for non-service lanes."""
    p = dsvc.prog_svc.shape[0]
    return torch.where(svc_idx >= 0, dsvc.prog_svc[svc_idx.clamp(0, p - 1)],
                       MISS)


def entry_timeout(conf, proto, timeouts, xp=torch):
    """Per-entry idle timeout from the CONFIRMED bit + protocol (xp=np on
    host arrays: the engine's dump and audit decode)."""
    t_syn, t_est, t_onew, t_oest = timeouts
    is_tcp = proto == PROTO_TCP
    out = xp.where(
        is_tcp,
        xp.where(conf != 0, t_est, t_syn),
        xp.where(conf != 0, t_oest, t_onew),
    )
    return out.astype(np.int32) if xp is np else out.to(_I32)


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
    lens=None,
    prune_exclude=None,
):
    """One step, synchronous at meta.phases == PH_ALL; see the module
    docstring and PH_*.

    valid / no_commit are optional (B,) lane masks (the forwarding walk's,
    models/forwarding.py): lanes outside valid neither hit, refresh,
    classify nor commit, and keep the plain ALLOW image; no_commit lanes
    classify but write no cache entry and report committed 0.  hit_combine
    is the rule-axis seam (ops/match.classify_batch; parallel/mesh.py): the
    tables are then one rule shard's, the one-pass slow path runs B3's
    hits-only variant and resolves after the combine.  lens ((B,) byte
    lengths, None for 0) feeds the counters of meta.count_flow_stats.
    meta.telemetry adds the tel_* outputs: the probe split of the valid
    lanes (hit, stale: the key matched but the entry aged out, miss), the
    one-pass dispatch's TEL_HALF_BLOCK count, and the inserts second chance
    suppressed.  meta.lb_stats adds lb_stats, the Service LB's counters
    (LB_STATS, (6,) int32) over the step's classified misses.
    prune_exclude ((B,) bool, None for none) marks lanes whose
    prune evidence and probe counters another dispatch owns (the mesh
    engine's spilled lanes, metered by their home-routed retry): they
    classify and serve as usual but count in neither.

    v6 = (src6w_f (B, 4), dst6w_f (B, 4), is6 (B,)) are the v6 lanes of a
    dual-stack step (meta.key_words == 10; None: every lane v4), which then
    also outputs dnat_w_f, the (B, 4) wide DNAT view (a reply hit's is the
    un-DNAT frontend).  A v4 step refuses v6 lanes."""
    A = meta.key_words - 2  # address columns: 2 (v4) or 8 (wide)
    if meta.onepass and (A != 2 or meta.match.prune_budget <= 0):
        raise ValueError(
            "the one-kernel fast path (onepass) requires the narrow v4 "
            "key layout and an aggregate-pruned meta (prune_budget > 0)")
    sp = tracing.SLOT.sp
    if sp is not None:
        sp.enter("walk.probe")
    flow, aff = state.flow, state.aff
    dev = src_f.device
    B = src_f.shape[0]
    N = meta.flow_slots
    M = meta.miss_chunk
    dump = N
    DC, M1C, RC, ZC = _meta_cols(A)
    now = int(now)
    gen_w = int(gen) % GEN_ETERNAL  # never == GEN_ETERNAL
    pp = _pair16(sport, dport)

    # ---- fast path: flow-cache lookup ----
    if A == 2:
        if v6 is not None:
            raise ValueError(
                "v6 lanes require a dual_stack pipeline "
                "(make_pipeline(dual_stack=True))")
        saddr = daddr = is6 = None
        addr = torch.stack([src_f, dst_f], dim=1)
        h = hashing.flow_hash(_raw_bits(src_f), _raw_bits(dst_f), proto,
                              sport, dport)
    else:
        # Every lane as a 4-word v4-mapped or v6 address pair.
        saddr, daddr, is6 = _wide_lanes(src_f, dst_f, v6)
        addr = torch.cat([saddr, daddr], dim=1)
        h = _wide_hash(saddr, daddr, proto, sport, dport)
    slot = h & (N - 1)
    pg_cur = proto | 0x100 | (gen_w << 9)
    pg_est = proto | 0x100 | (GEN_ETERNAL << 9)
    hit, est, rpl, mr, kr0, ts0 = _cache_lookup(
        flow, slot, addr, pp, pg_cur, pg_est, now, proto, meta)
    if valid is not None:
        # Lanes outside the mask (SpoofGuard, ARP, IGMP punt: handled
        # before conntrack) neither refresh nor commit any state.
        valid = valid != 0
        hit, est, rpl = hit & valid, est & valid, rpl & valid
    if no_commit is not None:
        no_commit = no_commit != 0
    tel = None
    if meta.telemetry:
        # The probe split, from the key rows the probe gathered: stale is
        # a key match whose entry aged out; generation-stale denials count
        # as misses.  Valid lanes only.
        tv = torch.ones_like(hit) if valid is None else valid
        if prune_exclude is not None:
            tv = tv & ~(prune_exclude != 0)
        kpg0 = kr0[:, A + 1]
        key_hit0 = ((kr0[:, :A] == addr).all(dim=1) & (kr0[:, A] == pp)
                    & ((kpg0 == pg_cur) | (kpg0 == pg_est)
                       | (kpg0 == (pg_est | REPLY_BIT))))
        tel = {"tel_probe_hit": (hit & tv).sum(dtype=_I32),
               "tel_probe_stale": (key_hit0 & ~hit & tv).sum(dtype=_I32),
               "tel_probe_miss": (~key_hit0 & tv).sum(dtype=_I32)}
    c_code, c_svc, c_dport = _unpack_meta1(mr[:, M1C])
    # The narrow dnat view (wide rows: word 3, a don't-care for v6 lanes,
    # whose consumers read c_dnat_w).
    c_dnat_ip = mr[:, DC]
    c_dnat_w = mr[:, 0:4] if A == 8 else None
    c_rule_in, c_rule_out = _unpack_rules(mr[:, RC])

    # Idle-timeout refresh for hits (every duplicate writes the same value).
    flow.ts[torch.where(hit, slot, dump)] = now
    if meta.second_chance:
        # A hit is the entry's reference: its collision counter resets.
        tgt_h = torch.where(hit, slot, dump)
        flow.meta[tgt_h, ZC] = flow.meta[tgt_h, ZC] & ~CHANCE_MASK
    if meta.count_flow_stats:
        _count_hits(flow, slot, hit, lens, dump)

    # Deferred partner refresh: conntrack refreshes both directions, so an
    # established hit whose partner stamp is older than ct_timeout/2 walks
    # to its partner entry (recomputed from the cached DNAT meta and
    # key-verified) and refreshes it.
    p_half = max(1, meta.ct_timeout_s // 2)
    pmask = meta.pref_mask
    c_pref = mr[:, ZC] & pmask
    p_need = est & (((now - c_pref) & pmask) >= p_half)
    # SYN_SENT -> ESTABLISHED on the first reply-direction hit.
    conf_need = rpl & (((mr[:, ZC] >> 29) & 1) == 0)
    # TCP teardown: FIN or RST on an established entry removes both
    # directions after this packet's own verdict.
    td = (est & (proto == PROTO_TCP) & ((flags & _TEARDOWN_FLAGS) != 0)
          if flags is not None else torch.zeros_like(est))
    miss = ~hit if valid is None else ~hit & valid
    # The step's one read-back: which conditional phases run, and the
    # miss count that sizes the round loop.
    any_p, any_c, any_t, n_miss = torch.stack([
        p_need.any().long(), conf_need.any().long(), td.any().long(),
        miss.sum()]).tolist()
    if sp is not None:
        sp.leave()

    def partner_probe(keys, mask):
        """Each lane's partner tuple (the other direction of its hit
        entry), key-verified against `keys`: a forward hit pairs with
        (dnat, src), a reply hit with (dst, the cached frontend), in wide
        words on a dual-stack step.  -> (p_slot, live_mask)."""
        p_sport = torch.where(rpl, dport, c_dport)
        p_dport = torch.where(rpl, c_dport, sport)
        p_pg = torch.where(rpl, pg_est, pg_est | REPLY_BIT)
        if A == 2:
            p_src = torch.where(rpl, dst_f, c_dnat_ip)
            p_dst = torch.where(rpl, c_dnat_ip, src_f)
            p_addr = torch.stack([p_src, p_dst], dim=1)
            p_h = hashing.flow_hash(_raw_bits(p_src), _raw_bits(p_dst), proto,
                                    p_sport, p_dport)
        else:
            rplw = rpl[:, None]
            p_srcw = torch.where(rplw, daddr, c_dnat_w)
            p_dstw = torch.where(rplw, c_dnat_w, saddr)
            p_addr = torch.cat([p_srcw, p_dstw], dim=1)
            p_h = _wide_hash(p_srcw, p_dstw, proto, p_sport, p_dport)
        p_slot = p_h & (N - 1)
        pkr = keys[p_slot]
        live = (
            mask
            & (pkr[:, :A] == p_addr).all(dim=1)
            & (pkr[:, A] == _pair16(p_sport, p_dport))
            & (pkr[:, A + 1] == p_pg)
        )
        return p_slot, live

    if any_p:
        p_slot, p_live = partner_probe(flow.keys, p_need)
        flow.ts[torch.where(p_live, p_slot, dump)] = now
        # Attempt-time stamp even when the partner is gone; the cached
        # snat/dsr/conf bits are preserved.  Under second chance they are
        # read from the current meta: the hit's reset above cleared the
        # counter, which the start-of-batch row still holds.
        tgt_p = torch.where(p_need, slot, dump)
        keep = flow.meta[tgt_p, ZC] if meta.second_chance else mr[:, ZC]
        flow.meta[tgt_p, ZC] = (now & pmask) | (keep & ~pmask)

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
    # meta.miss_code, the verdict they keep when the slow path is masked;
    # lanes outside valid are not misses and keep the plain ALLOW image.
    zero = torch.zeros(B, dtype=_I32, device=dev)
    fwd_hit = hit & ~rpl
    img = torch.cat([torch.stack([
        torch.where(hit, c_code, torch.where(miss, meta.miss_code,
                                             ACT_ALLOW)),
        torch.where(hit, c_rule_in, MISS),
        torch.where(hit, c_rule_out, MISS), torch.where(hit, c_svc, MISS),
        torch.where(hit, c_dnat_ip, dst_f), torch.where(hit, c_dport, dport),
        torch.where(fwd_hit, (mr[:, ZC] >> 31) & 1, 0),
        torch.where(fwd_hit, (mr[:, ZC] >> 30) & 1, 0), zero],
        dim=1).to(_I32), torch.zeros((1, 9), dtype=_I32, device=dev)])
    # The wide DNAT image (dual-stack): hits read the cached words, misses
    # start from their literal dst words.
    img_w = None
    if A == 8:
        img_w = torch.cat([torch.where(hit[:, None], c_dnat_w, daddr),
                           torch.zeros((1, 4), dtype=_I32, device=dev)])
    n_evict = n_reclaim = torch.zeros((), dtype=_I32, device=dev)
    prune_on = meta.match.prune_budget > 0
    # Prune counters: aggregate-AND skips, full-width fallbacks, and the
    # candidate-superblock histogram (_prune_bucket_counts layout).
    prune = (zero[0], zero[0],
             torch.zeros(len(PRUNE_HIST_BOUNDS) + 2, dtype=_I32, device=dev))
    # Second chance's suppressed inserts (meta.telemetry).
    n_chance = zero[0]
    # The Service LB's counters (meta.lb_stats), summed over the rounds.
    lbc = (torch.zeros(len(LB_STATS), dtype=_I32, device=dev)
           if meta.lb_stats else None)

    # ---- slow path: ServiceLB + classify + commit, misses only ----
    # With PH_SLOW masked (the async fast step) misses keep the fast-path
    # image and nothing commits.
    slow = n_miss > 0 and bool(meta.phases & PH_SLOW)
    if slow and meta.onepass:
        fresh, n_evict, n_reclaim, prune, sc, lbc1 = _slow_onepass(
            state, drs, dsvc, src_f, dst_f, proto, sport, dport, pp, h, slot,
            miss, mr, kr0, ts0, now, gen_w, meta, valid, no_commit,
            hit_combine, lens, prune_exclude)
        img[:B] = torch.where(miss[:, None], fresh, img[:B])
        if sc is not None:
            n_chance = n_chance + sc
        if lbc1 is not None:
            lbc = lbc1
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
        # Every rank of a rule group runs the same rounds: they hold the
        # same state and lanes, and each round's combine is collective.
        for r in range(rounds):
            if sp is not None:
                sp.enter("walk.classify")
            idx = midx[r * M:(r + 1) * M]
            valid_m = idx < B
            safe = idx.clamp(0, B - 1)
            if no_commit is not None:
                no_commit_m = no_commit[safe]
            s_f = src_f[safe]
            d_f = dst_f[safe]
            p_m = proto[safe]
            sp_m = sport[safe]
            dp_m = dport[safe]
            wide_m = v6_m = None
            if A == 8:
                wide_m = (saddr[safe], daddr[safe], is6[safe])

            lb = _lb_phase(meta, aff_snap, dsvc, h[safe], s_f, d_f, p_m,
                           dp_m, now, wide=wide_m)
            (svc_idx, no_ep, dnat_ip, dnat_port, snat_m, dsr_m, dnat_w,
             learn) = lb
            if lbc is not None:
                lbc[:4] += _lb_counts(lb, valid_m)
            if A == 8:
                # The post-DNAT words double as the classifier's v6 lanes.
                v6_m = (wide_m[0], dnat_w, wide_m[2])
            # Lanes classify on their POST-DNAT tuple; PH_CLS_SUM alone runs
            # the pruned classifier's aggregate phase only.
            cls = None
            if meta.phases & PH_CLS or (prune_on
                                        and meta.phases & PH_CLS_SUM):
                cls = classify_batch(
                    drs, s_f, dnat_ip, p_m, dnat_port, meta=meta.match,
                    hit_combine=hit_combine, fused=meta.fused, v6=v6_m,
                    svc_ref=_svc_ref_of(svc_idx, dsvc),
                    summary_only=not meta.phases & PH_CLS,
                    delta_n=meta.delta_n)
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
                # B-1 and must not count, nor lanes another dispatch owns.
                pv = valid_m
                if prune_exclude is not None:
                    pv = pv & ~(prune_exclude[safe] != 0)
                prune = (
                    prune[0] + (cls["prune_skip"] & pv).sum(dtype=_I32),
                    prune[1] + (cls["prune_fb"] & pv).sum(dtype=_I32),
                    prune[2] + _prune_bucket_counts(cls["prune_cand"], pv))
            rows = _fused_pack_rows(
                s_f, d_f, p_m, sp_m, dp_m, pp[safe], code, svc_idx, dnat_ip,
                dnat_port, snat_m, dsr_m, rule_in, rule_out, valid_m,
                no_commit_m, now, gen_w, N, pmask,
                wide=None if A == 2 else (wide_m[0], wide_m[1], dnat_w))
            # Results into the output images (miss lanes are distinct;
            # padding lanes write the dump row).
            tgt = torch.where(valid_m, idx, B)
            img[tgt] = torch.stack(
                [code, rule_in, rule_out, svc_idx, dnat_ip, dnat_port,
                 snat_m, dsr_m, rows["committed"]], dim=1).to(_I32)
            if img_w is not None:
                img_w[tgt] = dnat_w
            if sp is not None:
                sp.leave()
            if meta.phases & PH_COMMIT:
                lv = (lens[safe] if meta.count_flow_stats
                      and lens is not None else None)
                ev, rc, sc, census = _commit(
                    state, slot[safe], rows, learn, learn["mask"] & valid_m,
                    now, gen_w, meta, lv,
                    dsvc.aff_timeout if lbc is not None else None)
                n_evict, n_reclaim = n_evict + ev, n_reclaim + rc
                if sc is not None:
                    n_chance = n_chance + sc
                if census is not None:
                    lbc[4:] += census

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
    if img_w is not None:
        # The wide DNAT view; a v4 lane's word 3 is dnat_ip_f.
        out["dnat_w_f"] = img_w[:B]
    if tel is not None:
        # Keys exist iff meta.telemetry.  The one-pass dispatch counts the
        # JAX kernel's half-blocks of the padded batch (TEL_TILE).
        hb = ((B + (-B) % TEL_TILE) // TEL_HALF_BLOCK
              if slow and meta.onepass and meta.phases & PH_CLS else 0)
        out.update(tel, tel_dma_hb=torch.tensor(hb, dtype=_I32, device=dev),
                   tel_chance_bumps=n_chance)
    if lbc is not None:
        # The key exists iff meta.lb_stats.
        out["lb_stats"] = lbc
    return state, out


def _commit(state, slot, rows, learn, learn_mask, now, gen_w, meta,
            lv=None, aff_timeout=None):
    """In place: commit a set of lanes' forward and reply rows
    (_fused_pack_rows output, narrow or wide) interleaved per lane [fwd_i,
    rev_i], so last-writer-wins resolves collisions in per-lane insert
    order, and their affinity learns (a 4-word client row on a dual-stack
    state).  Under meta.second_chance the guard first drops
    the inserts that would evict a protected entry.  Under PH_EVICT the
    eviction census (an insert over a live entry whose tuple differs; a
    same-tuple rewrite is an update) reads each target's key row, and under
    meta.drain_reclaim also its CONFIRMED bit and ts, before the scatters.
    An overwritten row that is already dead to lookups (idle past its
    per-state timeout, or a denial of another generation) counts as a
    reclaim, not an eviction.  Under meta.count_flow_stats a forward entry
    starts at one packet of its lane's length (lv, None for 0), a reply
    entry at zero, and both high limbs at zero.  Given aff_timeout (the
    Services' affinity timeouts, dsvc.aff_timeout), the learn census reads
    each winning learn's target row before the scatters: the pins written
    and those that overwrite a live pin of another (client, Service) key.
    -> (evictions, reclaims, the guard's suppressed inserts or None),
    int32 scalars, and the learn census, (2,) int32 (LB_STATS[4:]), or
    None."""
    sp = tracing.SLOT.sp
    if sp is not None:
        sp.enter("walk.commit")
    flow, aff = state.flow, state.aff
    dump = meta.flow_slots
    A = meta.key_words - 2
    ZC = _meta_cols(A)[3]
    m = slot.shape[0]
    slot2 = torch.stack([slot, rows["rev_slot"].long()], dim=1).reshape(2 * m)
    keys2 = rows["keys8"].reshape(2 * m, A + 2)
    meta2 = rows["meta8"].reshape(2 * m, flow.meta.shape[1])
    ins2 = torch.stack([rows["ins"], rows["rev_ins"]], dim=1).reshape(2 * m)
    n_chance = None
    if meta.second_chance:
        ins2, n_chance = _second_chance_guard(flow, slot2, keys2, ins2, now,
                                              meta, dump)

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

    adump = meta.aff_slots
    census = None
    if aff_timeout is not None:
        # Each slot's winning learn once; it overwrites a live pin where
        # the row it lands on is younger than its own Service's timeout
        # and holds another client or Service.
        win = _winner_mask(adump, learn["aslot"], learn_mask, adump)
        tgt = torch.where(win, learn["aslot"], adump)
        o_svc = aff.key_svc[tgt]
        o_tmo = aff_timeout[o_svc.clamp(0, aff_timeout.shape[0] - 1).long()]
        live = (aff.ep[tgt] > 0) & ((now - aff.ts[tgt]) <= o_tmo)
        other = aff.key_client[tgt] != learn["client"]
        if other.dim() == 2:
            other = other.any(dim=1)
        other = other | (o_svc != learn["svc"])
        census = torch.stack([win, win & live & other]).sum(dim=1,
                                                             dtype=_I32)

    if meta.count_flow_stats:
        z = torch.zeros(m, dtype=_I32, device=slot.device)
        lv = z if lv is None else lv.clamp_min(0)
        win = _winner_mask(dump, slot2, ins2, dump)
        tgt = torch.where(win, slot2, dump)
        flow.pkts[tgt] = torch.stack([torch.ones_like(z), z], 1).reshape(-1)
        flow.octets[tgt] = torch.stack([lv, z], 1).reshape(-1)
        flow.pkts_hi[tgt] = 0
        flow.octets_hi[tgt] = 0
    _scatter_last(flow.keys, slot2, keys2, ins2, dump)
    _scatter_last(flow.meta, slot2, meta2, ins2, dump)
    _scatter_last(flow.ts, slot2, torch.full((2 * m,), now, dtype=_I32,
                                             device=slot.device), ins2, dump)
    _scatter_last(aff.key_client, learn["aslot"], learn["client"], learn_mask,
                  adump)
    _scatter_last(aff.key_svc, learn["aslot"], learn["svc"], learn_mask, adump)
    _scatter_last(aff.ep, learn["aslot"], learn["ep"], learn_mask, adump)
    _scatter_last(aff.ts, learn["aslot"],
                  torch.full((m,), now, dtype=_I32, device=slot.device),
                  learn_mask, adump)
    if sp is not None:
        sp.leave()
    return n_evict, n_reclaim, n_chance, census


def _onepass_probes(drs, dsvc, src_f, proto, svc_idx, dnat_ip, dnat_port,
                    miss, meta):
    """The one-pass path's classification probes on the post-DNAT tuple
    (pipeline.py:1684-1711), in torch (ops/onepass.lane_probes): the
    miss-masked interval rows (hit lanes take row 0), the six aggregate
    rows (the svcref row ORed into egress svc) and the isolation bits.
    B3 runs them itself; the PH_CLS_SUM chain runs them here.
    -> (iv6, iv_ref, aggs, iso_in, iso_out)."""
    svcref = meta.match.svcref
    tabs = onepass.tables_of(drs, dsvc.prog_svc if svcref else None)
    rows, ref_row, aggs, iso_in, iso_out = onepass.lane_probes(
        tabs, svcref, miss, src_f, proto, svc_idx, dnat_ip, dnat_port)
    return ([r.to(_I32) for r in rows], ref_row.to(_I32), aggs, iso_in,
            iso_out)


def _onepass_inputs(aff, drs, dsvc, src_f, dst_f, proto, sport, dport, pp, h,
                    kr0, mr, ts0, now, meta, lb=None, valid=None,
                    no_commit=None, fb_force=None):
    """ServiceLB over the whole batch (under PH_LB) and B3's lane inputs,
    tables and shape constants: the lane columns, the cache rows gathered
    at batch start (kr0/mr/ts0), the lane masks (valid / no_commit /
    fb_force bool, None for all valid / none / none) and the rule tables;
    B3 runs the probes itself.  lb is _lb_phase's result when the caller
    has it.
    -> (onepass.OnepassInputs, onepass.OnepassTables,
    onepass.OnepassStatic, the affinity learn dict)."""
    if lb is None:
        lb = _lb_phase(meta, aff, dsvc, h, src_f, dst_f, proto, dport, now)
    svc_idx, no_ep, dnat_ip, dnat_port, snat_m, dsr_m, _dw, learn = lb
    mm = meta.match
    z = torch.zeros_like(src_f)
    x = onepass.OnepassInputs(
        pkt=torch.stack([src_f, dst_f, proto, sport, dport, pp, z, z], dim=1),
        kr=kr0, ts=ts0, mrow=mr,
        msk=torch.stack([
            torch.ones_like(z) if valid is None else valid.to(_I32),
            z if no_commit is None else no_commit.to(_I32),
            z if fb_force is None else fb_force.to(_I32), z], dim=1),
        lb=torch.stack([svc_idx, no_ep.to(_I32), dnat_ip, dnat_port, snat_m,
                        dsr_m, z, z], dim=1))
    tabs = onepass.tables_of(drs, dsvc.prog_svc if mm.svcref else None)
    st = onepass.OnepassStatic(
        k=mm.prune_budget, in_phases=mm.in_phases, out_phases=mm.out_phases,
        svcref=mm.svcref, timeouts=meta.timeouts, n_slots=meta.flow_slots,
        pref_mask=meta.pref_mask)
    return x, tabs, st, learn


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
                  slot, miss, mr, kr0, ts0, now, gen_w, meta, valid=None,
                  no_commit=None, hit_combine=None, lens=None,
                  prune_exclude=None):
    """The one-pass slow path (pipeline.py:1638-2071).  Under PH_CLS: B3
    over the whole batch, the full-width re-walk of its fallback lanes
    (through B1) and the prune counters.  On one card B3 runs its resolve
    variant; under hit_combine (a rule shard) its hits-only variant, and
    the re-walk at the shard's own width, the combine of the hits and the
    prune observables, the resolve and the row packing follow in torch
    (pipeline.py:1910-1935).  Without PH_CLS B3 does not run: under
    PH_CLS_SUM the aggregate AND alone gives the skip and candidate counts
    of the miss lanes and every live lane the default-verdict image; with
    neither bit every lane default-allows.  Then, under PH_COMMIT, one
    interleaved commit of every lane's rows.
    -> (the miss lanes' images (B, 9), evictions, reclaims, (skips,
    fallbacks, candidate histogram), second chance's suppressed inserts or
    None, the LB's counters (LB_STATS, under meta.lb_stats) or None)."""
    sp = tracing.SLOT.sp
    if sp is not None:
        sp.enter("walk.classify")
    mm = meta.match
    N = meta.flow_slots
    lb = _lb_phase(meta, state.aff, dsvc, h, src_f, dst_f, proto, dport, now)
    svc_idx, no_ep, dnat_ip, dnat_port, snat_m, dsr_m, _dw, learn = lb
    lbc = _lb_counts(lb, miss) if meta.lb_stats else None
    nc = (torch.zeros_like(miss) if no_commit is None else no_commit)
    pv = torch.ones_like(miss) if valid is None else valid  # counted lanes
    if prune_exclude is not None:
        pv = pv & ~(prune_exclude != 0)
    zero = torch.zeros((), dtype=_I32, device=src_f.device)
    rows = None
    # Pending membership deltas (pipeline.py:1701-1728): every lane a slot
    # covers on src_f or dnat_ip takes the exact full-width fallback (B3's
    # fb_force); B3 reads unpatched tables, so those lanes' isolation bits
    # and prune observables are patched here and their re-walk reads a
    # DeltaOverlay.
    dn = meta.delta_n if meta.phases & (PH_CLS | PH_CLS_SUM) else 0
    delta_fb = None
    if dn > 0:
        d = drs.ip_delta
        delta_fb = (_delta_matches(src_f, d, dn)
                    | _delta_matches(dnat_ip, d, dn)).any(dim=1)
    if meta.phases & PH_CLS and hit_combine is None:
        # B3 runs the probes (interval rows, isolation bits, aggregate
        # rows) of its miss lanes itself and returns their interval rows.
        x, tabs, st, _ = _onepass_inputs(state.aff, drs, dsvc, src_f, dst_f,
                                         proto, sport, dport, pp, h, kr0, mr,
                                         ts0, now, meta, lb=lb, valid=valid,
                                         no_commit=no_commit,
                                         fb_force=delta_fb)
        main, keys8, meta8, aux, iv = onepass.onepass(x, tabs, now, gen_w,
                                                      st)
        ov = _delta_fixup(drs, tabs, iv, aux, delta_fb, miss, src_f,
                          dnat_ip, dn, mm.svcref)

        fb = torch.nonzero(aux[:, 1]).flatten()
        if fb.numel():
            # Lanes with more than K candidate superblocks (and lanes a
            # delta covers): the exact full-width walk (the function B1
            # computes, so through B1's wrapper) at B3's interval rows,
            # resolved with its isolation bits (iv column 7), packed again,
            # written back lane for lane.
            iv_f = iv[fb]
            hits = rewalk_hits(tabs.inc, iv, fb, ov, mm)
            lb_f, pkt = x.lb[fb], x.pkt[fb]
            no_ep_f = lb_f[:, 1] != 0
            f_code, f_ri, f_ro = _fresh_code(drs, hits[:, :6].unbind(1),
                                             iv_f[:, 7] & 1, iv_f[:, 7] >> 1,
                                             no_ep_f)
            fix = _fused_pack_rows(
                *pkt[:, :6].unbind(1), f_code, lb_f[:, 0], lb_f[:, 2],
                lb_f[:, 3], lb_f[:, 4], lb_f[:, 5], f_ri, f_ro, miss[fb],
                nc[fb], now, gen_w, N, meta.pref_mask)
            main[fb, 0] = f_code
            main[fb, 1] = f_ri
            main[fb, 2] = f_ro
            main[fb, 8] = fix["committed"].to(_I32)
            main[fb, 9] = fix["rev_ins"].to(_I32)
            keys8[fb] = fix["keys8"]
            meta8[fb] = fix["meta8"]

        skip, fbv, cand = aux[:, 0], aux[:, 1], aux[:, 2]
        rows = dict(rev_slot=main[:, 10], keys8=keys8, meta8=meta8,
                    ins=main[:, 14] != 0, rev_ins=main[:, 9] != 0)
        fresh = main[:, :9]
    elif meta.phases & PH_CLS:
        # A rule shard: the hits of this shard's words, its fallback lanes
        # re-walked at the shard's width (fb is shard-local: no collective
        # may depend on it), then one combine of the six hits and the three
        # prune observables.
        x, tabs, st, _ = _onepass_inputs(state.aff, drs, dsvc, src_f, dst_f,
                                         proto, sport, dport, pp, h, kr0, mr,
                                         ts0, now, meta, lb=lb, valid=valid,
                                         no_commit=no_commit,
                                         fb_force=delta_fb)
        w0 = shard_offsets(hit_combine)
        hits8, aux, iv = onepass.onepass(x, tabs, now, gen_w, st, *w0,
                                         resolve=False)
        ov = _delta_fixup(drs, tabs, iv, aux, delta_fb, miss, src_f,
                          dnat_ip, dn, mm.svcref)
        fb = torch.nonzero(aux[:, 1]).flatten()
        if fb.numel():
            hits8[fb, :6] = rewalk_hits(tabs.inc, iv, fb, ov, mm, *w0)
        comb = hit_combine(torch.cat(
            [hits8[:, :6], aux[:, :1], 1 - aux[:, 1:2], -aux[:, 2:3]], dim=1))
        skip, fbv, cand = comb[:, 6], 1 - comb[:, 7], -comb[:, 8]
        f_code, f_ri, f_ro = _fresh_code(drs, comb[:, :6].unbind(1),
                                         iv[:, 7] & 1, iv[:, 7] >> 1, no_ep)
    elif meta.phases & PH_CLS_SUM:
        # The aggregate AND and short circuit only, over the miss lanes:
        # live lanes take the default-verdict image.
        _, _, aggs, iso_in, iso_out = _onepass_probes(
            drs, dsvc, src_f, proto, svc_idx, dnat_ip, dnat_port, miss, meta)
        if dn > 0:
            # Pending deltas patch the isolation bits and the aggregate
            # rows (pipeline.py:1700-1711).
            d = drs.ip_delta
            iso_in = _patch_iso(iso_in, dnat_ip, d, 0, dn)
            iso_out = _patch_iso(iso_out, src_f, d, 1, dn)
            aggs = list(aggs)
            for i, key, masks in ((0, dnat_ip, d.at_in), (1, src_f, d.peer_in),
                                  (3, src_f, d.at_out),
                                  (4, dnat_ip, d.peer_out)):
                aggs[i] = _patch_agg(aggs[i], key, d, masks, dn)
        ncs = [torch.where(miss, ((a & p & s) != 0).sum(dim=1, dtype=_I32), 0)
               for a, p, s in (aggs[:3], aggs[3:])]
        cand = torch.maximum(ncs[0], ncs[1])
        skip = (miss & (cand == 0)).to(_I32)
        if hit_combine is not None:
            comb = hit_combine(torch.stack([skip, -cand], dim=1))
            skip, cand = comb[:, 0], -comb[:, 1]
        fbv = torch.zeros_like(skip)
        bigs = torch.full_like(src_f, BIG)
        f_code, f_ri, f_ro = _fresh_code(drs, (bigs,) * 6, iso_in, iso_out,
                                         no_ep)
    else:
        # Neither classify bit: the staged default-allow image.
        f_code = torch.where(no_ep, ACT_REJECT, ACT_ALLOW).to(_I32)
        f_ri = f_ro = torch.full_like(f_code, MISS)
    if rows is None:
        rows = _fused_pack_rows(
            src_f, dst_f, proto, sport, dport, pp, f_code, svc_idx, dnat_ip,
            dnat_port, snat_m, dsr_m, f_ri, f_ro, miss, nc, now, gen_w, N,
            meta.pref_mask)
        fresh = torch.stack([f_code, f_ri, f_ro, svc_idx, dnat_ip, dnat_port,
                             snat_m, dsr_m, rows["committed"]], dim=1).to(_I32)
    if meta.phases & (PH_CLS | PH_CLS_SUM):
        prune = (((skip != 0) & pv).sum(dtype=_I32),
                 ((fbv != 0) & pv).sum(dtype=_I32),
                 _prune_bucket_counts(cand, miss & pv))
    else:
        prune = (zero, zero, torch.zeros(len(PRUNE_HIST_BOUNDS) + 2,
                                         dtype=_I32, device=zero.device))

    if sp is not None:
        sp.leave()
    n_evict = n_reclaim = zero
    sc = census = None
    if meta.phases & PH_COMMIT:
        n_evict, n_reclaim, sc, census = _commit(
            state, slot, rows, learn, learn["mask"] & miss, now, gen_w, meta,
            lens if meta.count_flow_stats else None,
            dsvc.aff_timeout if meta.lb_stats else None)
    if lbc is not None:
        lbc = torch.cat([lbc, census if census is not None
                         else torch.zeros(2, dtype=_I32, device=lbc.device)])
    return fresh, n_evict, n_reclaim, prune, sc, lbc


def _delta_fixup(drs, tabs, iv, aux, delta_fb, miss, src_f, dnat_ip, n: int,
                 svcref: bool):
    """In place, after B3: for the miss lanes a delta covers (forced to the
    fallback), the isolation bits of iv column 7 patched, and the skip and
    candidate counts of aux recomputed from the patched aggregate rows, as
    the JAX kernel computed them.  -> their DeltaOverlay, or None."""
    if delta_fb is None:
        return None
    lanes = torch.nonzero(delta_fb & miss).flatten()
    ov = delta_overlay(drs, iv, src_f, dnat_ip, n, lanes=lanes,
                       with_agg=True)
    if ov is None:
        return None
    d = drs.ip_delta
    iso = iv[lanes, 7]
    iso_in = _patch_iso(iso & 1, dnat_ip[lanes], d, 0, n)
    iso_out = _patch_iso(iso >> 1, src_f[lanes], d, 1, n)
    iv[lanes, 7] = iso_in | (iso_out << 1)
    ivl = iv[lanes].long()
    s_out = tabs.agg[5][ivl[:, 5]]
    if svcref:
        s_out = s_out | tabs.agg[5][ivl[:, 6]]
    ncs = [((a & p & s) != 0).sum(dim=1, dtype=_I32) for a, p, s in (
        (ov.aggs[0], ov.aggs[1], tabs.agg[2][ivl[:, 2]]),
        (ov.aggs[2], ov.aggs[3], s_out))]
    aux[lanes, 0] = ((ncs[0] == 0) & (ncs[1] == 0)).to(_I32)
    aux[lanes, 2] = torch.maximum(ncs[0], ncs[1])
    return ov


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


# ---- the engine's off-step device hooks (pipeline.py:2189-2494) -----------


def cache_stats(state: PipelineState) -> dict:
    """Flow-cache census (full scan, not for the per-step path): occupied,
    committed (ETERNAL generation, reply legs included) and denial entries,
    and the slot count; int32 scalars.  The keys come in sorted order, as
    the JAX package's jitted census returns them (a dict pytree flattens
    sorted), so the engines' cache_stats() print alike."""
    kpg = state.flow.keys[:-1, -1]
    valid = kpg != 0
    est = valid & (((kpg >> 9) & GEN_ETERNAL) == GEN_ETERNAL)
    return {
        "committed": est.sum(dtype=_I32),
        "denials": (valid & ~est).sum(dtype=_I32),
        "occupied": valid.sum(dtype=_I32),
        "slots": torch.tensor(kpg.shape[0], dtype=_I32),
    }


def audit_gather(state: PipelineState, cursor: int, *, window: int):
    """Rows [cursor, cursor + window) of the flow cache, mod the slot count
    (the dump row excluded) -> (keys, meta, ts): the device side of one
    audit step."""
    n = state.flow.keys.shape[0] - 1
    idx = (torch.arange(window, device=state.flow.keys.device)
           + int(cursor)) % n
    return state.flow.keys[idx], state.flow.meta[idx], state.flow.ts[idx]


def audit_evict(state: PipelineState, slots: torch.Tensor):
    """In place: clear the key rows of `slots` ((K,) int32, -1 padding
    ignored), so those flows reclassify on their next packet.
    -> (state, n int32)."""
    n = state.flow.keys.shape[0] - 1
    live = (slots >= 0) & (slots < n)
    state.flow.keys[torch.where(live, slots, n).long()] = 0
    return state, live.sum(dtype=_I32)


def tree_leaves(tree) -> list:
    """The tensor leaves of a NamedTuple tree in field order, None skipped
    (jax.tree_util.tree_leaves' order on the JAX package's twins)."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _digest_words_of(t: torch.Tensor) -> torch.Tensor:
    """A tensor -> a flat int32 view (32-bit dtypes reinterpreted, others
    value-cast), as pipeline.py:2359 does."""
    t = t.reshape(-1)
    if t.dtype == _I32:
        return t
    if t.element_size() == 4:
        return t.view(_I32)
    return t.to(_I32)


def _xor_fold(words: torch.Tensor) -> torch.Tensor:
    """(N,) int32, N >= 1 -> () int32 XOR of all words, by halving."""
    while words.shape[0] > 1:
        if words.shape[0] % 2:
            words = torch.cat([words, words.new_zeros(1)])
        pair = words.view(-1, 2)
        words = pair[:, 0] ^ pair[:, 1]
    return words[0]


def tensor_digest(leaves) -> int:
    """Checksum-scrub digest of tensor leaves (pipeline.py:2370): per leaf
    the XOR fold and the wrapping sum of its int32 words, folded into one
    host int the same way, so a table's digest equals the JAX package's.
    One read-back for all leaves."""
    pairs = []
    for leaf in leaves:
        words = _digest_words_of(leaf)
        if words.shape[0] == 0:
            pairs.append(None)
            continue
        pairs.append(torch.stack([_xor_fold(words).to(torch.int64),
                                  words.sum(dtype=torch.int64)]).cpu())
    h = 0
    for pr in pairs:
        xor, s = (0, 0) if pr is None else (int(pr[0]) & 0xFFFFFFFF,
                                            int(pr[1]) & 0xFFFFFFFF)
        h = (h * 1000003 + xor) & 0xFFFFFFFFFFFFFFFF
        h = (h * 1000003 + s) & 0xFFFFFFFFFFFFFFFF
    return h


def pipeline_trace(state: PipelineState, drs: DeviceRuleSet,
                   dsvc: DeviceServiceTables, src_f, dst_f, proto, sport,
                   dport, now: int, gen: int, *, meta: PipelineMeta,
                   hit_combine=None, v6=None) -> dict:
    """Read-only per-packet stage trace (pipeline.py:2388): every packet
    walks ServiceLB and the full classifier (the instance's fused and
    pruned meta, its pending deltas) whatever its cache state, and the
    cache lookup is reported beside it.  No state is written.  On a
    dual-stack meta, v6 lanes as in pipeline_step, and the wide views
    dnat_w_f and cached_dnat_w_f."""
    flow, aff = state.flow, state.aff
    N = meta.flow_slots
    A = meta.key_words - 2
    now = int(now)
    gen_w = int(gen) % GEN_ETERNAL
    pp = _pair16(sport, dport)
    wide = None
    if A == 2:
        if v6 is not None:
            raise ValueError(
                "v6 lanes require a dual_stack pipeline "
                "(make_pipeline(dual_stack=True))")
        addr = torch.stack([src_f, dst_f], dim=1)
        h = hashing.flow_hash(_raw_bits(src_f), _raw_bits(dst_f), proto,
                              sport, dport)
    else:
        wide = _wide_lanes(src_f, dst_f, v6)
        addr = torch.cat(wide[:2], dim=1)
        h = _wide_hash(*wide[:2], proto, sport, dport)
    slot = h & (N - 1)
    pg_cur = proto | 0x100 | (gen_w << 9)
    pg_est = proto | 0x100 | (GEN_ETERNAL << 9)
    hit, est, rpl, mr, _kr, _ts = _cache_lookup(
        flow, slot, addr, pp, pg_cur, pg_est, now, proto, meta)
    DC, M1C, _RC, _ZC = _meta_cols(A)
    c_code, _c_svc, c_dport = _unpack_meta1(mr[:, M1C])
    svc_idx, no_ep, dnat_ip, dnat_port, snat, dsr, dnat_w, _learn = (
        _service_lb(aff, dsvc, h, src_f, dst_f, proto, dport, now,
                    meta.aff_slots, wide=wide))
    cls = classify_batch(drs, src_f, dnat_ip, proto, dnat_port,
                         meta=meta.match, hit_combine=hit_combine,
                         fused=meta.fused, svc_ref=_svc_ref_of(svc_idx, dsvc),
                         delta_n=meta.delta_n,
                         v6=None if wide is None else (wide[0], dnat_w,
                                                       wide[2]))
    fresh_code = torch.where(no_ep, ACT_REJECT, cls["code"]).to(_I32)
    code = torch.where(hit, c_code, fresh_code)
    out = {
        "cache_hit": hit.to(_I32),
        "est": est.to(_I32),
        "reply": rpl.to(_I32),
        "cached_code": torch.where(hit, c_code, -1),
        "cached_dnat_ip_f": mr[:, DC],
        "cached_dnat_port": c_dport,
        "svc_idx": svc_idx,
        "no_ep": no_ep.to(_I32),
        "dnat_ip_f": dnat_ip,
        "dnat_port": dnat_port,
        "snat": snat,
        "dsr": dsr,
        "egress_code": cls["egress_code"],
        "egress_rule": cls["egress_rule"],
        "ingress_code": cls["ingress_code"],
        "ingress_rule": cls["ingress_rule"],
        "fresh_code": fresh_code,
        "code": code,
        "reject_kind": reject_kind_of(code, proto),
    }
    if A == 8:
        out["dnat_w_f"] = dnat_w
        out["cached_dnat_w_f"] = mr[:, 0:4]
    return out
