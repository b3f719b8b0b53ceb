"""Batched conjunctive-match classification: the PyTorch port of
antrea_tpu/ops/match.py (v4, single card, no delta patching).

Per packet and direction: an interval lookup per dimension (appliedTo, peer,
service) over that dimension's own boundaries, one incidence-row gather per
dimension, the AND of the three rows, and per rule phase the lowest set rule
index (rule order is priority order).  The AND and the phase scan are the
B1 consumer (ops/consumer.py, a CUDA kernel on the card); the interval
lookups and row gathers stay torch ops.

With prune_budget = K > 0 the tables carry an aggregate level (one bit per
incidence word, one aggregate word per 32-word superblock) and classify runs
the two-level pruned walk (_classify_pruned): the aggregate AND proves most
lanes no-match, the K lowest candidate superblocks are scanned through the
B2 consumer (ops/pruned_consumer.py), and lanes with more than K candidates
fall back to the full-width walk through B1, so verdicts stay exact.

The host-side table builders (to_host and helpers) are the JAX package's
numpy code, copied.  Every u32 table becomes an int32 tensor with the same
bits (torch's CPU uint32 has no shifts or compares).  IPs are sign-flipped
so signed compares give unsigned order (see compiler/compile.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..compiler.compile import (
    ACT_ALLOW,
    ACT_DROP,
    ACT_PASS,
    SVCREF_BASE,
    SVCREF_NONE,
    CompiledPolicySet,
    DirectionTensors,
)
from ..utils import ip as iputil
from . import consumer, pruned_consumer

# "No match" sentinel for first-match indices (the kernel's too).
BIG = consumer.BIG

# Aggregated-bitmap pruning.  One aggregate bit summarizes one incidence
# word (32 rules); one aggregate word a 32-word superblock (1024 rules), the
# granularity of the candidate gather.  Aggregate bits are conservative: a
# zero aggregate AND proves no match; a set bit may still find none.
AGG_BLOCK = 32
# The prune budget's rung ladder (the JAX package's autotuner moves on it).
PRUNE_LADDER = (1, 2, 4, 8, 16)
# Candidate-superblock histogram bucket bounds (per-lane max over the two
# directions), shared with models/pipeline._prune_bucket_counts.
PRUNE_HIST_BOUNDS = (0, 1, 2, 4, 8, 16, 32)
# Smallest fallback rung of the JAX package's pow2 redispatch ladder.  The
# port compacts the fallback lanes exactly (nonzero), so it has no rungs;
# kept for parity of the constants.
_FB_MIN = 64


class DimTable(NamedTuple):
    """One match dimension: interval bounds + rule-incidence rows.

    Rows 0..NB4 are the v4 interval space; rows NB4+1.. the v6 space (this
    port classifies v4 lanes only, but keeps the table layout)."""

    bounds: torch.Tensor  # (NB4,) int32 ascending (sign-flipped for IP dims)
    bounds6: torch.Tensor  # (NB6, 4) int32, v6 boundaries
    inc: torch.Tensor  # (NB4+1+NB6+1, W) int32 (u32 bits) rule bitmaps
    # (rows, W/AGG_BLOCK) int32 aggregate level (build_agg), None unpruned.
    agg: Optional[torch.Tensor] = None


class DeviceDirection(NamedTuple):
    at: DimTable  # appliedTo, probed with the pod-side IP
    peer: DimTable  # peer, probed with the other side's IP
    svc: DimTable  # service, probed with (proto << 16 | dst_port)
    action: torch.Tensor  # (W*32,) int32
    l7: torch.Tensor  # (W*32,) int32 0/1 L7-redirect mark per rule
    word_idx: torch.Tensor  # (W,) int32 global word index


class IsoTable(NamedTuple):
    """K8s default-deny isolation membership (one bit per packet)."""

    bounds: torch.Tensor  # (K4,) int32 sign-flipped
    bounds6: torch.Tensor  # (K6, 4) int32
    val: torch.Tensor  # (K4+1+K6+1,) int32 0/1


class DeltaTable(NamedTuple):
    """Incremental membership-delta table, kept for layout parity with the
    JAX package.  Delta patching is not ported: its one slot is always
    empty (to_host refuses delta_slots > 0)."""

    lo_f: torch.Tensor
    hi_f: torch.Tensor
    sign: torch.Tensor
    iso: torch.Tensor
    at_in: torch.Tensor
    peer_in: torch.Tensor
    at_out: torch.Tensor
    peer_out: torch.Tensor
    n: torch.Tensor
    fam: torch.Tensor
    lo6_w: torch.Tensor
    hi6_w: torch.Tensor


class DeviceRuleSet(NamedTuple):
    ingress: DeviceDirection
    egress: DeviceDirection
    iso_in: IsoTable
    iso_out: IsoTable
    ip_delta: DeltaTable


class StaticMeta(NamedTuple):
    """Shape constants of a rule set (plain ints, not tensors)."""

    in_phases: tuple[int, int, int]  # (n_phase0, n_k8s, n_baseline)
    out_phases: tuple[int, int, int]
    w_in: int  # ingress rule words
    w_out: int
    # Egress rules include toServices lowerings: classify_batch probes the
    # egress svc dimension a second time with the lane's service reference.
    svcref: bool = False
    # K candidate superblocks per lane and direction of the pruned walk;
    # 0 = no aggregate level (the tables carry agg=None).
    prune_budget: int = 0


def empty_delta(slots: int, w_in: int, w_out: int, xp=np) -> DeltaTable:
    return DeltaTable(
        lo_f=xp.full((slots,), 2**31 - 1, dtype=xp.int32),
        hi_f=xp.full((slots,), -(2**31), dtype=xp.int32),
        sign=xp.zeros((slots,), dtype=xp.int32),
        iso=xp.zeros((slots,), dtype=xp.int32),
        at_in=xp.zeros((slots, w_in), dtype=xp.uint32),
        peer_in=xp.zeros((slots, w_in), dtype=xp.uint32),
        at_out=xp.zeros((slots, w_out), dtype=xp.uint32),
        peer_out=xp.zeros((slots, w_out), dtype=xp.uint32),
        n=xp.zeros((), dtype=xp.int32),
        fam=xp.zeros((slots,), dtype=xp.int32),
        lo6_w=xp.full((slots, 4), 2**31 - 1, dtype=xp.int32),
        hi6_w=xp.full((slots, 4), -(2**31), dtype=xp.int32),
    )


# ---------------------------------------------------------------------------
# Host-side table construction (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _rules_by_gid(gids: np.ndarray) -> dict[int, np.ndarray]:
    order = np.argsort(gids, kind="stable").astype(np.int64)
    sg = gids[order]
    uniq, starts = np.unique(sg, return_index=True)
    out: dict[int, np.ndarray] = {}
    for i, g in enumerate(uniq):
        end = starts[i + 1] if i + 1 < len(uniq) else len(sg)
        out[int(g)] = order[starts[i] : end]
    return out


def _inc_mask(rule_idx: np.ndarray, w: int) -> np.ndarray:
    """Rule indices -> (w,) u32 bitmap."""
    inc = np.zeros(w, dtype=np.uint32)
    np.bitwise_or.at(inc, rule_idx >> 5, (1 << (rule_idx & 31)).astype(np.uint32))
    return inc


def build_agg(inc: np.ndarray) -> np.ndarray:
    """(rows, W) u32 incidence -> (rows, ceil(W/AGG_BLOCK)) u32 aggregate:
    bit j of aggregate word s == (inc word s*AGG_BLOCK+j) != 0."""
    inc = np.asarray(inc)
    rows, w = inc.shape
    s = -(-w // AGG_BLOCK)
    pad = s * AGG_BLOCK - w
    if pad:
        inc = np.pad(inc, ((0, 0), (0, pad)))
    nz = (inc.reshape(rows, s, AGG_BLOCK) != 0).astype(np.uint32)
    return (nz << np.arange(AGG_BLOCK, dtype=np.uint32)[None, None, :]).sum(
        axis=2, dtype=np.uint32)  # disjoint bits: sum == OR


_V6_OFF = iputil.V6_OFF
_V6_END = 1 << 128  # exclusive end of the v6-relative space


def _span_list(bounds: list, lo: int, hi: int) -> tuple[int, int]:
    """[lo, hi) range -> inclusive interval-row span [a, b] over a SORTED
    python-int bounds list (bisect 'right' index space, row i covering
    (bounds[i-1], bounds[i]])."""
    import bisect

    a = bisect.bisect_right(bounds, lo)
    b = bisect.bisect_right(bounds, hi - 1)
    return a, b


def _family_split(lo: int, hi: int):
    """Combined-keyspace [lo, hi) -> (v4 part or None, v6-relative part or
    None); family-spanning ranges (any-peer) contribute to both."""
    v4 = v6 = None
    if lo < (1 << 32):
        v4 = (lo, min(hi, 1 << 32))
    if hi > _V6_OFF:
        v6 = (max(lo, _V6_OFF) - _V6_OFF, hi - _V6_OFF)
    return v4, v6


def _dual_bounds(range_lists) -> tuple[list, list]:
    """Boundary points of both families from combined ranges."""
    p4: set[int] = set()
    p6: set[int] = set()
    for ranges in range_lists:
        for lo, hi in ranges:
            r4, r6 = _family_split(int(lo), int(hi))
            if r4 is not None:
                p4.add(r4[0])
                if r4[1] < (1 << 32):
                    p4.add(r4[1])
            if r6 is not None:
                p6.add(r6[0])
                if r6[1] < _V6_END:
                    p6.add(r6[1])
    return sorted(p4), sorted(p6)


def _v6_words(vals: list) -> np.ndarray:
    """Sorted v6-relative ints -> (N, 4) sign-flipped i32 word quadruples
    (lexicographic order preserved word-wise)."""
    out = np.zeros((len(vals), 4), dtype=np.uint32)
    for i, v in enumerate(vals):
        out[i] = [(v >> 96) & 0xFFFFFFFF, (v >> 64) & 0xFFFFFFFF,
                  (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF]
    return iputil.flip_u32(out)


def _paint(b4: list, b6: list, lo: int, hi: int, write) -> None:
    """Paint combined range [lo, hi) into the dual interval row space via
    the write(row_a, row_b) callback: v4 rows [0..len(b4)], v6 rows
    [len(b4)+1 ..]."""
    r4, r6 = _family_split(int(lo), int(hi))
    if r4 is not None and r4[0] < r4[1]:
        a, b = _span_list(b4, *r4)
        write(a, b)
    if r6 is not None and r6[0] < r6[1]:
        a, b = _span_list(b6, *r6)
        off = len(b4) + 1
        write(off + a, off + b)


def _dim_table_host(gids: np.ndarray, groups: list, w: int, ip_dim: bool,
                    agg: bool = False) -> DimTable:
    """Build one dimension's (bounds, bounds6, incidence) triple.

    Only the groups this dimension actually uses contribute boundary points,
    so each dimension's interval table stays as small as its own address
    structure (the appliedTo dimension is typically far coarser than peer).
    """
    by = _rules_by_gid(gids)
    b4, b6 = _dual_bounds(groups[g] for g in by)
    if not ip_dim:
        # svc keys live entirely below 2^32; no v6 sub-space.
        b6 = []
    n_rows = len(b4) + 1 + (len(b6) + 1 if ip_dim else 0)
    inc = np.zeros((n_rows, w), dtype=np.uint32)
    for g, rr in by.items():
        ranges = groups[g]
        if not ranges or rr.size == 0:
            continue
        gmask = _inc_mask(rr, w)
        nzw = np.nonzero(gmask)[0]
        vals = gmask[nzw]

        def write(a, b):
            inc[a : b + 1][:, nzw] |= vals

        for lo, hi in ranges:
            if ip_dim:
                _paint(b4, b6, lo, hi, write)
            else:
                a, b = _span_list(b4, int(lo), int(hi))
                write(a, b)
    if ip_dim:
        bounds = iputil.flip_u32(np.array(b4, dtype=np.uint64).astype(np.uint32))
        bounds6 = _v6_words(b6)
    else:
        bounds = np.array(b4, dtype=np.int64).astype(np.int32)
        bounds6 = np.zeros((0, 4), dtype=np.int32)
    return DimTable(bounds=bounds, bounds6=bounds6, inc=inc,
                    agg=build_agg(inc) if agg else None)


def _iso_host(gid: int, groups: list) -> IsoTable:
    ranges = groups[gid]
    b4, b6 = _dual_bounds([ranges])
    val = np.zeros(len(b4) + 1 + len(b6) + 1, dtype=np.int32)

    def write(a, b):
        val[a : b + 1] = 1

    for lo, hi in ranges:
        _paint(b4, b6, lo, hi, write)
    return IsoTable(
        bounds=iputil.flip_u32(np.array(b4, dtype=np.uint64).astype(np.uint32)),
        bounds6=_v6_words(b6),
        val=val,
    )


def _direction_host(
    dt: DirectionTensors, cps: CompiledPolicySet, w: int, agg: bool = False
) -> DeviceDirection:
    action = np.full(w * 32, ACT_DROP, dtype=np.int32)
    action[: dt.n_rules] = dt.action
    l7 = np.zeros(w * 32, dtype=np.int32)
    if dt.l7 is not None:
        l7[: dt.n_rules] = dt.l7
    return DeviceDirection(
        at=_dim_table_host(dt.at_gid, cps.ip_groups, w, ip_dim=True, agg=agg),
        peer=_dim_table_host(dt.peer_gid, cps.ip_groups, w, ip_dim=True,
                             agg=agg),
        svc=_dim_table_host(dt.svc_gid, cps.svc_groups, w, ip_dim=False,
                            agg=agg),
        action=action,
        l7=l7,
        word_idx=np.arange(w, dtype=np.int32),
    )


def _width(n_rules: int, word_multiple: int, agg: bool = False) -> int:
    # Under pruning each (shard's) word range is a whole number of
    # superblocks, so aggregate words never straddle a shard boundary.
    if agg:
        word_multiple *= AGG_BLOCK
    w = max(1, -(-n_rules // 32))
    return -(-w // word_multiple) * word_multiple


def to_host(
    cps: CompiledPolicySet,
    word_multiple: int = 1,
    delta_slots: int = 0,
    prune_budget: int = 0,
) -> tuple[DeviceRuleSet, StaticMeta]:
    """Compiled policy set -> (numpy DeviceRuleSet, StaticMeta), array for
    array the JAX package's to_host at delta_slots=0.

    word_multiple pads each direction's rule-word count to a multiple.
    prune_budget > 0 builds the aggregate tables (DimTable.agg) and sets the
    pruned classify's K.  Delta patching is not ported: delta_slots > 0
    raises NotImplementedError."""
    if delta_slots > 0:
        raise NotImplementedError("delta patching (delta_slots > 0) is not "
                                  "ported yet")
    agg = prune_budget > 0
    w_in = _width(cps.ingress.n_rules, word_multiple, agg=agg)
    w_out = _width(cps.egress.n_rules, word_multiple, agg=agg)
    drs = DeviceRuleSet(
        ingress=_direction_host(cps.ingress, cps, w_in, agg=agg),
        egress=_direction_host(cps.egress, cps, w_out, agg=agg),
        iso_in=_iso_host(cps.iso_in_gid, cps.ip_groups),
        iso_out=_iso_host(cps.iso_out_gid, cps.ip_groups),
        ip_delta=empty_delta(1, w_in, w_out, xp=np),
    )
    meta = StaticMeta(
        in_phases=(cps.ingress.n_phase0, cps.ingress.n_k8s, cps.ingress.n_baseline),
        out_phases=(cps.egress.n_phase0, cps.egress.n_k8s, cps.egress.n_baseline),
        w_in=w_in,
        w_out=w_out,
        svcref=cps.has_svcref,
        prune_budget=prune_budget,
    )
    return drs, meta


# ---------------------------------------------------------------------------
# Device placement
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """None -> the card.  Asking for CUDA where there is none raises: no
    entry point falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _tensor(a, device) -> Optional[torch.Tensor]:
    """numpy-like array -> tensor on `device` (a copy); u32 becomes int32
    with the same bits."""
    if a is None:
        return None
    a = np.array(a, copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def from_numpy(cls, src, device, nested=None):
    """Build NamedTuple `cls` from any object with the same field names
    whose leaves are numpy-like arrays (e.g. the JAX package's to_host or
    jax.device_get output).  nested maps (cls, field) -> the NamedTuple
    class of a sub-tree."""
    nested = nested or {}
    kw = {}
    for f in cls._fields:
        v = getattr(src, f)
        sub = nested.get((cls, f))
        kw[f] = (from_numpy(sub, v, device, nested) if sub is not None
                 else _tensor(v, device))
    return cls(**kw)


def tree_map(fn, tree):
    """Apply fn to every tensor leaf of a NamedTuple tree (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return fn(tree)


_RULESET_TREE = {
    (DeviceRuleSet, "ingress"): DeviceDirection,
    (DeviceRuleSet, "egress"): DeviceDirection,
    (DeviceRuleSet, "iso_in"): IsoTable,
    (DeviceRuleSet, "iso_out"): IsoTable,
    (DeviceRuleSet, "ip_delta"): DeltaTable,
    (DeviceDirection, "at"): DimTable,
    (DeviceDirection, "peer"): DimTable,
    (DeviceDirection, "svc"): DimTable,
}


def ruleset_from_numpy(drs_np, device=None) -> DeviceRuleSet:
    """A numpy DeviceRuleSet (this package's to_host, or the JAX
    package's) -> this package's DeviceRuleSet of tensors on `device`."""
    return from_numpy(DeviceRuleSet, drs_np, resolve_device(device),
                      _RULESET_TREE)


def to_device(
    cps: CompiledPolicySet,
    device=None,
    word_multiple: int = 1,
    prune_budget: int = 0,
) -> tuple[DeviceRuleSet, StaticMeta]:
    host, meta = to_host(cps, word_multiple, prune_budget=prune_budget)
    return ruleset_from_numpy(host, device), meta


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------


def _dim_index(tab, x: torch.Tensor) -> torch.Tensor:
    """Interval row index of v4 lanes: searchsorted(side='right') in the v4
    sub-space, as int64 indices."""
    return torch.searchsorted(tab.bounds, x, right=True)


def _svcref_key(svc_key: torch.Tensor, svc_ref) -> torch.Tensor:
    """The toServices second probe key: the lane's service index mapped into
    the SVCREF_BASE sub-space, SVCREF_NONE for non-service lanes."""
    if svc_ref is None:
        return torch.full_like(svc_key, SVCREF_NONE)
    return torch.where(svc_ref >= 0, SVCREF_BASE + svc_ref, SVCREF_NONE)


def _resolve(action: torch.Tensor, hits, pod_iso: torch.Tensor):
    """Phase resolution -> (code (B,), rule_idx (B,) [-1 = default])."""
    h0, hk, hb = hits
    n = action.shape[0]
    a0 = action[h0.clamp(0, n - 1).long()]
    ab = action[hb.clamp(0, n - 1).long()]
    return _resolve_from_actions(a0, ab, hits, pod_iso)


def _resolve_from_actions(a0, ab, hits, pod_iso):
    h0, hk, hb = hits
    has0 = h0 < BIG
    hask = hk < BIG
    hasb = hb < BIG

    decided0 = has0 & (a0 != ACT_PASS)
    decidedb = hasb & (ab != ACT_PASS)

    # K8s NP rules are any-match ALLOW within the isolation model.
    k8s_code = torch.where(hask, ACT_ALLOW, ACT_DROP)
    k8s_rule = torch.where(hask, hk, -1)

    code = torch.where(
        decided0, a0,
        torch.where(pod_iso == 1, k8s_code,
                    torch.where(decidedb, ab, ACT_ALLOW)),
    )
    rule = torch.where(
        decided0, h0,
        torch.where(pod_iso == 1, k8s_rule,
                    torch.where(decidedb, hb, -1)),
    )
    return code.to(torch.int32), rule.to(torch.int32)


def _refuse(**knobs) -> None:
    """Raise NotImplementedError naming the first knob set to a value this
    port does not implement (a truthy value)."""
    for name, on in knobs.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")


def classify_batch(
    drs: DeviceRuleSet,
    src_ip_f: torch.Tensor,  # (B,) int32 sign-flipped
    dst_ip_f: torch.Tensor,
    proto: torch.Tensor,  # (B,) int32
    dst_port: torch.Tensor,  # (B,) int32
    *,
    meta: StaticMeta,
    hit_combine=None,
    fused: bool = False,
    v6=None,
    svc_ref=None,
    summary_only: bool = False,
):
    """-> dict with final/egress/ingress codes and deciding rule indices
    (codes: 0 allow, 1 drop, 2 reject).

    fused=True runs the AND and phase scan through the B1 consumer
    (ops/consumer.py: the CUDA kernel on the card); fused=False runs the
    same function as plain tensor ops.  svc_ref (B,) is the lane's service
    index for the toServices probe (used when meta.svcref).
    meta.prune_budget > 0 (tables with an aggregate level) routes through
    the two-level pruned walk, _classify_pruned; summary_only is its
    profiling sub-mode (the aggregate phase alone, live lanes take the
    default verdicts) and is ignored without pruning.  Rule-axis sharding
    (hit_combine) and v6 lanes are not ported."""
    _refuse(hit_combine=hit_combine is not None, v6=v6 is not None)
    if meta.prune_budget > 0 and drs.ingress.at.agg is not None:
        return _classify_pruned(drs, src_ip_f, dst_ip_f, proto, dst_port,
                                meta=meta, fused=fused, svc_ref=svc_ref,
                                summary_only=summary_only)
    ing, eg = drs.ingress, drs.egress
    svc_key = (proto << 16) | dst_port

    def dim_row(tab: DimTable, x: torch.Tensor) -> torch.Tensor:
        return tab.inc[_dim_index(tab, x)]

    def iso_bit(tab: IsoTable, x: torch.Tensor) -> torch.Tensor:
        return tab.val[_dim_index(tab, x)]

    # Ingress: pod = dst, peer = src.  Egress: pod = src, peer = dst.
    in_at = dim_row(ing.at, dst_ip_f)
    in_peer = dim_row(ing.peer, src_ip_f)
    in_svc = dim_row(ing.svc, svc_key)
    out_at = dim_row(eg.at, src_ip_f)
    out_peer = dim_row(eg.peer, dst_ip_f)
    out_svc = dim_row(eg.svc, svc_key)
    if meta.svcref:
        # OR is exact: ordinary port ranges live below SVCREF_BASE and
        # reference ranges at SVCREF_BASE + idx (compiler/compile.py).
        out_svc = out_svc | dim_row(eg.svc, _svcref_key(svc_key, svc_ref))
    iso_in = iso_bit(drs.iso_in, dst_ip_f)
    iso_out = iso_bit(drs.iso_out, src_ip_f)

    if fused:
        hits = consumer.fused_hits(
            (in_at, in_peer, in_svc), (out_at, out_peer, out_svc),
            meta.in_phases, meta.out_phases)
        in_hits = (hits[:, 0], hits[:, 1], hits[:, 2])
        out_hits = (hits[:, 3], hits[:, 4], hits[:, 5])
    else:
        in_hits = consumer.phase_hits(in_at & in_peer & in_svc, 0,
                                      meta.in_phases)
        out_hits = consumer.phase_hits(out_at & out_peer & out_svc, 0,
                                       meta.out_phases)

    in_code, in_rule = _resolve(ing.action, in_hits, iso_in)
    out_code, out_rule = _resolve(eg.action, out_hits, iso_out)

    final = torch.where(out_code != ACT_ALLOW, out_code, in_code)
    return {
        "code": final,
        "egress_code": out_code,
        "egress_rule": out_rule,
        "ingress_code": in_code,
        "ingress_rule": in_rule,
    }


def _classify_pruned(drs: DeviceRuleSet, src_ip_f, dst_ip_f, proto,
                     dst_port, *, meta: StaticMeta, fused: bool, svc_ref,
                     summary_only: bool = False):
    """The two-level pruned classify (match.py:_classify_pruned), v4, one
    card.  An aggregate bit is set iff its incidence word is nonzero, so a
    zero aggregate AND proves no match and the candidate superblocks cover
    every matching word.  Candidates are scanned lowest first, so a phase
    hit among the K lowest is the true first match; lanes with more than K
    candidates in a direction redo both directions at full width.

    -> classify_batch's dict plus prune_skip (B,) bool (the aggregate AND
    is zero in both directions), prune_fb (B,) bool (the lane took the
    full-width fallback) and prune_cand (B,) int32 (candidate superblocks,
    max over the directions).

    summary_only (the PH_CLS_SUM profiling surface, match.py:1719): stop
    after the aggregate AND; every lane takes the default verdicts and
    nothing falls back."""
    ing, eg = drs.ingress, drs.egress
    B = src_ip_f.shape[0]
    K = meta.prune_budget
    svc_key = (proto << 16) | dst_port
    # Per direction: (tables, interval rows at/peer/svc, svcref row or
    # None).  Ingress: pod = dst probes appliedTo, peer = src.
    ref = (_dim_index(eg.svc, _svcref_key(svc_key, svc_ref))
           if meta.svcref else None)
    dirs = (
        (ing, (_dim_index(ing.at, dst_ip_f), _dim_index(ing.peer, src_ip_f),
               _dim_index(ing.svc, svc_key)), None),
        (eg, (_dim_index(eg.at, src_ip_f), _dim_index(eg.peer, dst_ip_f),
              _dim_index(eg.svc, svc_key)), ref),
    )
    iso_in = drs.iso_in.val[_dim_index(drs.iso_in, dst_ip_f)]
    iso_out = drs.iso_out.val[_dim_index(drs.iso_out, src_ip_f)]

    def rows(tab_of, dd, iv, iv_ref):
        """The three dimension rows of table kind tab_of ("agg"/"inc")."""
        a = getattr(dd.at, tab_of)[iv[0]]
        p = getattr(dd.peer, tab_of)[iv[1]]
        s = getattr(dd.svc, tab_of)[iv[2]]
        if iv_ref is not None:
            s = s | getattr(dd.svc, tab_of)[iv_ref]
        return a, p, s

    g, nc, ke = [], [], []
    for dd, iv, iv_ref in dirs:
        a, p, s = rows("agg", dd, iv, iv_ref)
        g.append(a & p & s)
        nc.append((g[-1] != 0).sum(dim=1, dtype=torch.int32))
        ke.append(min(K, dd.at.agg.shape[1]))
    live = (nc[0] > 0) | (nc[1] > 0)
    fb = (nc[0] > ke[0]) | (nc[1] > ke[1])
    if summary_only:
        any_live = 0
        fb = torch.zeros_like(fb)
    else:
        # One read-back: whether any lane has a candidate (else the whole
        # batch takes the default verdicts: no candidate gather, no
        # fallback) and how many lanes fall back.
        any_live, n_fb = torch.stack([live.any().long(), fb.sum()]).tolist()
    if any_live:
        mats = [_candidate_mats(dd, gd, iv, iv_ref, k)
                for (dd, iv, iv_ref), gd, k in zip(dirs, g, ke)]
        if fused:
            hits = pruned_consumer.pruned_hits(mats[0], mats[1],
                                               meta.in_phases, meta.out_phases)
        else:
            hits = pruned_consumer.pruned_plain(mats[0], mats[1],
                                                meta.in_phases,
                                                meta.out_phases)
        if n_fb:
            # Full-width walk of the compacted fallback lanes: the function
            # B1 computes, so it goes through B1's wrapper (the kernel on
            # the card), written back lane for lane.
            idx = torch.nonzero(fb).flatten()
            full = [rows("inc", dd, [r[idx] for r in iv],
                         None if iv_ref is None else iv_ref[idx])
                    for dd, iv, iv_ref in dirs]
            hits[idx] = consumer.fused_hits(full[0], full[1], meta.in_phases,
                                            meta.out_phases)
        in_hits = (hits[:, 0], hits[:, 1], hits[:, 2])
        out_hits = (hits[:, 3], hits[:, 4], hits[:, 5])
    else:
        bigs = torch.full((B,), BIG, dtype=torch.int32,
                          device=src_ip_f.device)
        in_hits = out_hits = (bigs, bigs, bigs)

    in_code, in_rule = _resolve(ing.action, in_hits, iso_in)
    out_code, out_rule = _resolve(eg.action, out_hits, iso_out)
    final = torch.where(out_code != ACT_ALLOW, out_code, in_code)
    return {
        "code": final,
        "egress_code": out_code,
        "egress_rule": out_rule,
        "ingress_code": in_code,
        "ingress_rule": in_rule,
        "prune_skip": (nc[0] == 0) & (nc[1] == 0),
        "prune_fb": fb,
        "prune_cand": torch.maximum(nc[0], nc[1]),
    }


def candidate_ids(g: torch.Tensor, ke: int) -> tuple:
    """Aggregate AND rows g (B, S) -> the ke lowest superblocks whose
    aggregate word is nonzero, ascending, as (ids clipped to S-1 (B, ke)
    int64, valid (B, ke) bool).  The values of lax.top_k(-score, ke) with
    fill S: taken from a sorted topk's values, never its indices, so ties
    among the fill scores cannot reorder anything."""
    S = g.shape[1]
    ids = torch.arange(S, dtype=torch.int32, device=g.device)
    score = torch.where(g != 0, ids, S)
    cand = torch.topk(score, ke, dim=1, largest=False, sorted=True).values
    return cand.clamp(max=S - 1).long(), cand < S


def candidate_blocks(inc: torch.Tensor, iv: torch.Tensor,
                     cand: torch.Tensor) -> torch.Tensor:
    """(rows, S*32) incidence, interval rows iv (B,), candidate superblocks
    cand (B, ke) -> the candidate words (B, ke, 32)."""
    S = inc.shape[1] // AGG_BLOCK
    return inc.view(-1, AGG_BLOCK)[iv.long()[:, None] * S + cand]


def candidate_base(cand: torch.Tensor, w0: int = 0) -> torch.Tensor:
    """Candidate superblocks (B, ke) -> the per-word base matrix
    (B, ke*32) int32: 32 * the global word index of each candidate word."""
    j = torch.arange(AGG_BLOCK, dtype=torch.int64, device=cand.device)
    base = (w0 + cand[:, :, None] * AGG_BLOCK + j) * 32
    return base.reshape(cand.shape[0], -1).to(torch.int32)


def _candidate_mats(dd: DeviceDirection, g, iv, iv_ref, ke):
    """B2's four (B, ke*32) int32 inputs of one direction: the candidate
    words of the three dimensions (the svcref row ORed into svc, fill
    candidates zeroed in one dimension so the AND kills them) and their
    base matrix.  One card: the direction's global word offset is 0."""
    cand, valid = candidate_ids(g, ke)
    B = g.shape[0]
    ca = candidate_blocks(dd.at.inc, iv[0], cand)
    cp = candidate_blocks(dd.peer.inc, iv[1], cand)
    cs = candidate_blocks(dd.svc.inc, iv[2], cand)
    if iv_ref is not None:
        cs = cs | candidate_blocks(dd.svc.inc, iv_ref, cand)
    ca = torch.where(valid[:, :, None], ca, 0)
    return (ca.reshape(B, -1), cp.reshape(B, -1), cs.reshape(B, -1),
            candidate_base(cand))


def make_classifier(cps: CompiledPolicySet, device=None):
    """-> (fn(src_f, dst_f, proto, dport, v6=None) -> verdict dict, DRS).
    fn takes tensors or numpy arrays and classifies on `device`, like the
    JAX package's make_classifier (the unfused scan)."""
    drs, meta = to_device(cps, device)
    dev = drs.ingress.action.device

    def fn(src_f, dst_f, proto, dport, v6=None):
        args = (torch.as_tensor(x, device=dev)
                for x in (src_f, dst_f, proto, dport))
        return classify_batch(drs, *args, meta=meta, v6=v6)

    return fn, drs
