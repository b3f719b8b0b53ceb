"""Batched conjunctive-match classification: the PyTorch port of
antrea_tpu/ops/match.py (v4 and v6 lanes), on one card or on one rule shard
of a mesh (parallel/mesh.py).

Per packet and direction: an interval lookup per dimension (appliedTo, peer,
service) over that dimension's own boundaries (a v6 lane looks its 4-word
address up in the dimension's v6 sub-space, whose rows follow the v4 ones:
_dim_index, _searchsorted6), one incidence-row gather per
dimension, the AND of the three rows, and per rule phase the lowest set rule
index (rule order is priority order).  With fused=True the row reads, the
AND and the phase scan are the B1 consumer (ops/consumer.py, a CUDA kernel
on the card, which reads the rows from the tables at the lanes' interval
rows); the interval lookups stay torch ops.

With prune_budget = K > 0 the tables carry an aggregate level (one bit per
incidence word, one aggregate word per 32-word superblock) and classify runs
the two-level pruned walk (_classify_pruned): the aggregate AND proves most
lanes no-match, the B2 consumer (ops/pruned_consumer.py) selects and scans
the K lowest candidate superblocks, and lanes with more than K candidates
fall back to the full-width walk through B1, so verdicts stay exact.

Pending membership deltas (DeltaTable, the engine's apply_group_delta)
patch the incidence rows of the lanes whose addresses a delta slot covers.
The kernels never see a gathered row, so those lanes go through an overlay
(_delta_overlay): their at/peer rows are gathered, patched slot after slot,
deduplicated and written into small per-dimension tables, and B1 (or B2) is
launched a second time on them with the overlay tables in place of the four
address tables.  Untouched lanes keep their path and launches.

The host-side table constructors (to_host and helpers) are the JAX package's
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
AGG_BLOCK = pruned_consumer.AGG_BLOCK
# The prune budget's rung ladder (PruneAutotuner moves on it) and its
# hysteresis: one rung per move, after PRUNE_STICKY same-direction signals
# of a fallback rate above PRUNE_FB_HIGH (up) or below PRUNE_FB_LOW (down).
PRUNE_LADDER = (1, 2, 4, 8, 16)
PRUNE_STICKY = 2
PRUNE_FB_HIGH = 0.05
PRUNE_FB_LOW = 0.005
# Candidate-superblock histogram bucket bounds (per-lane max over the two
# directions), shared with models/pipeline._prune_bucket_counts.
PRUNE_HIST_BOUNDS = (0, 1, 2, 4, 8, 16, 32)
# Smallest fallback rung of the JAX package's pow2 redispatch ladder.  The
# port compacts the fallback lanes exactly (nonzero), so it has no rungs;
# kept for parity of the constants.
_FB_MIN = 64


class DimTable(NamedTuple):
    """One match dimension: interval bounds + rule-incidence rows.

    Rows 0..NB4 are the v4 interval space; rows NB4+1.. the v6 space (ip
    dimensions only: the svc key space is shared by both families)."""

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
    """Fixed-capacity incremental membership-delta table (the JAX package's
    layout): a pod joining or leaving a group appends one slot carrying the
    affected address range and the pre-resolved rule masks of the
    dimensions whose gid is the patched group; classify patches the rows of
    the lanes the range covers before the AND.  Slots apply in append
    order, so a later clear undoes an earlier set on the same lane and bit.
    The number of active slots is a host int the caller passes (the
    engine's count; PipelineMeta.delta_n), so no step reads `n` back from
    the device.  Empty slots: sign == 0.  Slots are family-pure: a v4 slot
    (fam 0) covers [lo_f, hi_f] of v4 lanes, a v6 slot (fam 1) the
    lexicographic word range [lo6_w, hi6_w] of v6 lanes."""

    lo_f: torch.Tensor  # (D,) sign-flipped int32, inclusive
    hi_f: torch.Tensor  # (D,) sign-flipped int32, inclusive
    sign: torch.Tensor  # (D,) +1 set, -1 clear, 0 empty
    iso: torch.Tensor  # (D,) bit 0 patches iso_in, bit 1 iso_out
    at_in: torch.Tensor  # (D, W_in) rule mask of the ingress appliedTo dim
    peer_in: torch.Tensor  # (D, W_in)
    at_out: torch.Tensor  # (D, W_out)
    peer_out: torch.Tensor  # (D, W_out)
    n: torch.Tensor  # () active slots
    fam: torch.Tensor  # (D,) 0 v4 slot, 1 v6 slot
    lo6_w: torch.Tensor  # (D, 4)
    hi6_w: torch.Tensor  # (D, 4)


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
    # Delta-table capacity (DeltaTable slots); 0 = no incremental deltas.
    delta_slots: int = 0


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
    array the JAX package's to_host.

    word_multiple pads each direction's rule-word count to a multiple.
    delta_slots reserves the DeltaTable's capacity (one empty slot at 0).
    prune_budget > 0 builds the aggregate tables (DimTable.agg) and sets the
    pruned classify's K."""
    agg = prune_budget > 0
    w_in = _width(cps.ingress.n_rules, word_multiple, agg=agg)
    w_out = _width(cps.egress.n_rules, word_multiple, agg=agg)
    drs = DeviceRuleSet(
        ingress=_direction_host(cps.ingress, cps, w_in, agg=agg),
        egress=_direction_host(cps.egress, cps, w_out, agg=agg),
        iso_in=_iso_host(cps.iso_in_gid, cps.ip_groups),
        iso_out=_iso_host(cps.iso_out_gid, cps.ip_groups),
        ip_delta=empty_delta(max(delta_slots, 1), w_in, w_out, xp=np),
    )
    meta = StaticMeta(
        in_phases=(cps.ingress.n_phase0, cps.ingress.n_k8s, cps.ingress.n_baseline),
        out_phases=(cps.egress.n_phase0, cps.egress.n_k8s, cps.egress.n_baseline),
        w_in=w_in,
        w_out=w_out,
        delta_slots=delta_slots,
        svcref=cps.has_svcref,
        prune_budget=prune_budget,
    )
    return drs, meta


# ---------------------------------------------------------------------------
# Entry-axis rung padding (round 9, the multi-tenant packing layer)
# ---------------------------------------------------------------------------

# Smallest entry-axis rung a padded table lands on: interval-boundary
# counts below this all share one shape, so small tenants collapse onto
# one compiled program instead of one per distinct group structure.
ENTRY_RUNG_FLOOR = 16

# Padding boundary values: the MAXIMUM of each key space.  searchsorted
# side='right' counts bounds <= x, so every x below the maximum resolves
# to its original interval row unchanged; x == maximum lands past the
# pad block, which is why the padder REPLICATES the top row's incidence
# across the whole pad region (any bisect variant then reads the same
# row content).  For IP dims the flipped-space max is the flip of
# 255.255.255.255 == int32 max; svc keys live below 2^24, so int32 max
# is unreachable there outright.
_PAD_BOUND = 2**31 - 1


def _entry_cap(n: int, floor: int = ENTRY_RUNG_FLOOR) -> int:
    """Natural entry count -> its pow2 rung (0 stays 0: an empty v6
    sub-table is a SHAPE, shared by every all-v4 world on the rung)."""
    if n <= 0:
        return 0
    return max(floor, 1 << (n - 1).bit_length())


def _pad_rows(rows: np.ndarray, at: int, count: int) -> np.ndarray:
    """Insert `count` replicas of row `at` directly after it."""
    if count <= 0:
        return rows
    return np.concatenate(
        [rows[: at + 1], np.repeat(rows[at : at + 1], count, axis=0),
         rows[at + 1 :]], axis=0)


def _pad_dim_table(tab: DimTable, cap4: int, cap6: int) -> DimTable:
    bounds = np.asarray(tab.bounds)
    bounds6 = np.asarray(tab.bounds6)
    inc = np.asarray(tab.inc)
    nb4, nb6 = bounds.shape[0], bounds6.shape[0]
    ip_dim = inc.shape[0] == nb4 + 1 + nb6 + 1  # svc dims have no v6 rows
    p4 = max(0, cap4 - nb4)
    p6 = max(0, cap6 - nb6) if ip_dim else 0
    if p4 == 0 and p6 == 0:
        return tab
    if p4:
        bounds = np.concatenate(
            [bounds, np.full(p4, _PAD_BOUND, bounds.dtype)])
        inc = _pad_rows(inc, nb4, p4)  # replicate the v4 top row
    if p6:
        bounds6 = np.concatenate(
            [bounds6, np.full((p6, 4), _PAD_BOUND, bounds6.dtype)], axis=0)
        inc = _pad_rows(inc, inc.shape[0] - 1, p6)  # replicate the v6 top row
    return DimTable(
        bounds=bounds, bounds6=bounds6, inc=inc,
        agg=build_agg(inc) if tab.agg is not None else None)


def _pad_iso_table(tab: IsoTable, cap4: int, cap6: int) -> IsoTable:
    bounds = np.asarray(tab.bounds)
    bounds6 = np.asarray(tab.bounds6)
    val = np.asarray(tab.val)
    nb4, nb6 = bounds.shape[0], bounds6.shape[0]
    p4 = max(0, cap4 - nb4)
    p6 = max(0, cap6 - nb6)
    if p4 == 0 and p6 == 0:
        return tab
    if p4:
        bounds = np.concatenate(
            [bounds, np.full(p4, _PAD_BOUND, bounds.dtype)])
        val = _pad_rows(val, nb4, p4)
    if p6:
        bounds6 = np.concatenate(
            [bounds6, np.full((p6, 4), _PAD_BOUND, bounds6.dtype)], axis=0)
        val = _pad_rows(val, val.shape[0] - 1, p6)
    return IsoTable(bounds=bounds, bounds6=bounds6, val=val)


def pad_ruleset_entries(
    drs: DeviceRuleSet, cap4: Optional[int] = None,
    cap6: Optional[int] = None,
) -> tuple[DeviceRuleSet, tuple[int, int]]:
    """Pad every dimension's ENTRY axes (interval boundaries + incidence
    rows) of a HOST ruleset to pow2 rungs -> (padded drs, (cap4, cap6)).

    The word axis is already rung-shaped by the caller (padded rule
    counts through `_width`); this pads the other jit-signature axes —
    per-dim boundary counts, which otherwise vary with each tenant's
    group structure — so two rule worlds on the same rung produce
    IDENTICAL tensor shapes and share one compiled program (the
    multi-tenant shared-compile contract, datapath/tenancy.py).  Padding
    is semantically invisible: pad boundaries sit at the key-space
    maximum and every pad row replicates its neighbor's incidence, so no
    probe can resolve to different rule bits (regression-pinned by the
    tenancy parity suite).  Aggregate tables are rebuilt from the padded
    incidence (build_agg is the one constructor, so the scrub/property tests
    keep their consistency contract)."""
    dims = [drs.ingress.at, drs.ingress.peer, drs.ingress.svc,
            drs.egress.at, drs.egress.peer, drs.egress.svc]
    isos = [drs.iso_in, drs.iso_out]
    if cap4 is None:
        cap4 = _entry_cap(max(
            [np.asarray(t.bounds).shape[0] for t in dims + isos]))
    if cap6 is None:
        cap6 = _entry_cap(max(
            [np.asarray(t.bounds6).shape[0] for t in dims + isos]))

    def pad_dir(d: DeviceDirection) -> DeviceDirection:
        return d._replace(
            at=_pad_dim_table(d.at, cap4, cap6),
            peer=_pad_dim_table(d.peer, cap4, cap6),
            svc=_pad_dim_table(d.svc, cap4, cap6),
        )

    return drs._replace(
        ingress=pad_dir(drs.ingress),
        egress=pad_dir(drs.egress),
        iso_in=_pad_iso_table(drs.iso_in, cap4, cap6),
        iso_out=_pad_iso_table(drs.iso_out, cap4, cap6),
    ), (int(cap4), int(cap6))


class PruneAutotuner:
    """Bounded hysteresis controller for the prune K budget (the
    DrainAutotuner pattern, fed by the measured fallback rate instead of
    queue depth).  Pure decision logic: observe(classified, fallbacks)
    -> the budget for subsequent classifies.  One rung per move, only
    after `sticky` consecutive same-direction pressure signals; empty
    windows hold."""

    def __init__(self, initial: int, sticky: int = PRUNE_STICKY,
                 fb_high: float = PRUNE_FB_HIGH, fb_low: float = PRUNE_FB_LOW):
        self.rungs = list(PRUNE_LADDER)
        self.idx = min(
            range(len(self.rungs)),
            key=lambda i: (abs(self.rungs[i] - int(initial)), self.rungs[i]),
        )
        self.sticky = int(sticky)
        self.fb_high = float(fb_high)
        self.fb_low = float(fb_low)
        self._streak = 0
        self.decisions_up = 0
        self.decisions_down = 0

    @property
    def budget(self) -> int:
        return self.rungs[self.idx]

    def observe(self, classified: int, fallbacks: int) -> int:
        if classified <= 0:
            return self.budget  # empty window: no signal, streak kept
        rate = fallbacks / classified
        if rate > self.fb_high:
            signal = 1
        elif rate < self.fb_low:
            signal = -1
        else:
            signal = 0
        if signal == 0 or (self._streak and (signal > 0) != (self._streak > 0)):
            self._streak = signal
            return self.budget
        self._streak += signal
        if self._streak >= self.sticky and self.idx < len(self.rungs) - 1:
            self.idx += 1
            self.decisions_up += 1
            self._streak = 0
        elif self._streak <= -self.sticky and self.idx > 0:
            self.idx -= 1
            self.decisions_down += 1
            self._streak = 0
        return self.budget



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
    delta_slots: int = 0,
) -> tuple[DeviceRuleSet, StaticMeta]:
    host, meta = to_host(cps, word_multiple, delta_slots=delta_slots,
                         prune_budget=prune_budget)
    return ruleset_from_numpy(host, device), meta


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------


def _lex_le4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a <= b over a trailing 4-word axis of per-word
    sign-flipped int32 (match.py:620), so signed compares give the
    unsigned order of the 128-bit values."""
    lt = a < b
    eq = a == b
    return lt[..., 0] | (eq[..., 0] & (lt[..., 1] | (eq[..., 1] & (
        lt[..., 2] | (eq[..., 2] & (lt[..., 3] | eq[..., 3]))))))


def _key2(w: torch.Tensor) -> torch.Tensor:
    """(..., 4) per-word sign-flipped int32 -> (..., 2) int64 whose
    lexicographic signed order is _lex_le4's: each key is a word pair, the
    high (signed) word times 2**32 plus the low word's unsigned value."""
    w = w.to(torch.int64)
    return torch.stack([(w[..., 0] << 32) + (w[..., 1] + 2**31),
                        (w[..., 2] << 32) + (w[..., 3] + 2**31)], dim=-1)


def _le2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """_lex_le4 over _key2 keys (..., 2)."""
    return (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0])
                                      & (a[..., 1] <= b[..., 1]))


_KEY_MAX = 2**63 - 1


def _searchsorted6_many(bounds6s, xws) -> list:
    """_searchsorted6 of T (bounds6, lanes) pairs in one binary search:
    the tables' _key2 keys stacked into (T, P, 2), P the least power of
    two above every N, the rows past a table's own N padded with the
    largest key (>= every lane, so each table's predicate "row <= lane"
    stays a prefix), and each count capped at its N.  log2(P) steps of one
    (T, B, 2) gather each.  -> T (B,) int64 counts."""
    ns = [b.shape[0] for b in bounds6s]
    lanes = xws[0].shape[0]
    dev = xws[0].device
    if max(ns) == 0:
        return [torch.zeros(lanes, dtype=torch.int64, device=dev)
                for _ in ns]
    p = 1 << max(ns).bit_length()
    keys = torch.full((len(ns) * p, 2), _KEY_MAX, dtype=torch.int64,
                      device=dev)
    at = np.concatenate([t * p + np.arange(n) for t, n in enumerate(ns)])
    keys[torch.from_numpy(at).to(dev)] = _key2(torch.cat(bounds6s))
    keys = keys.view(len(ns), p, 2)
    xk = _key2(torch.stack(xws))  # (T, B, 2)
    pos = torch.zeros((len(ns), lanes), dtype=torch.int64, device=dev)
    step = p >> 1
    while step:
        row = keys.gather(1, (pos + (step - 1))[..., None].expand(-1, -1, 2))
        le = torch.where(row[..., 0] == xk[..., 0], row[..., 1] <= xk[..., 1],
                         row[..., 0] < xk[..., 0])
        pos = pos + le * step
        step >>= 1
    cap = torch.tensor(ns, dtype=torch.int64, device=dev)[:, None]
    return list(torch.minimum(pos, cap))


def _searchsorted6(bounds6: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """Lexicographic searchsorted(side='right') over 4-word v6 boundaries:
    per lane of xw (B, 4), the number of rows of bounds6 (N, 4), sorted
    ascending, that are <= it (match.py:1170; 0 when N == 0).

    The JAX package compares every lane with every bound, a (B, N)
    intermediate; here a binary search over the bounds' _key2 keys takes
    log2(N) + 1 steps of one (B,) gather each (_searchsorted6_many).
    Pad rows (the all-ones address) sit at the end, so the predicate "row
    <= lane" stays a prefix and the count is exact, duplicates
    included."""
    return _searchsorted6_many([bounds6], [xw])[0]


def _dim_index(tab, x: torch.Tensor, x6w=None, is6=None) -> torch.Tensor:
    """Interval row index for one dimension (int64): searchsorted
    (side='right') in the v4 sub-space, or, for a v6 lane (is6 != 0), its
    4-word address x6w searched in the v6 sub-space, offset past the v4
    rows (match.py:813).  x6w None: no v6 lanes in this probe (a v4 batch,
    or the family-blind svc key space)."""
    i4 = torch.searchsorted(tab.bounds, x, right=True)
    if x6w is None:
        return i4
    return _rows6(tab, i4, _searchsorted6(tab.bounds6, x6w), is6)


def _rows6(tab, i4, n6, is6):
    """A dimension's interval rows from the v4 index i4 and the v6 count n6:
    a v6 lane's row lies past the v4 rows (the DimTable layout)."""
    return torch.where(is6 != 0, tab.bounds.shape[0] + 1 + n6, i4)


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


def tables(drs: DeviceRuleSet) -> tuple:
    """The six incidence tables in the kernels' order: ingress at, peer,
    svc, then egress at, peer, svc."""
    ing, eg = drs.ingress, drs.egress
    return tuple(t.inc for t in (ing.at, ing.peer, ing.svc, eg.at, eg.peer,
                                 eg.svc))


def lane_rows(drs: DeviceRuleSet, src_ip_f, dst_ip_f, svc_key,
              ref_key=None, v6=None):
    """The lanes' interval rows and isolation bits -> (iv, iso_in,
    iso_out): iv (B, 8) int32 [in_at, in_peer, in_svc, out_at, out_peer,
    out_svc, svcref_row, 0], ingress probing appliedTo with the pod side
    (dst) and peer with src, egress the reverse, svcref_row the egress svc
    row of ref_key (0 without one); iso_in on dst, iso_out on src.  v6 =
    (src6w, dst6w, is6): v6 lanes take their ip rows in the tables' v6
    sub-spaces, all six found by one _searchsorted6_many."""
    ing, eg = drs.ingress, drs.egress
    ip_tabs = (ing.at, ing.peer, eg.at, eg.peer, drs.iso_in, drs.iso_out)
    on_dst = (True, False, False, True, True, False)
    ip = [torch.searchsorted(t.bounds, dst_ip_f if d else src_ip_f,
                             right=True) for t, d in zip(ip_tabs, on_dst)]
    if v6 is not None:
        s6, d6, is6 = v6
        six = _searchsorted6_many([t.bounds6 for t in ip_tabs],
                                  [d6 if d else s6 for d in on_dst])
        ip = [_rows6(t, i4, n6, is6) for t, i4, n6 in zip(ip_tabs, ip, six)]
    cols = [ip[0], ip[1], _dim_index(ing.svc, svc_key), ip[2], ip[3],
            _dim_index(eg.svc, svc_key)]
    z = torch.zeros_like(cols[0])
    ref = z if ref_key is None else _dim_index(eg.svc, ref_key)
    iv = torch.stack([*cols, ref, z], dim=1).to(torch.int32)
    return iv, drs.iso_in.val[ip[4]], drs.iso_out.val[ip[5]]


def interval_rows(drs: DeviceRuleSet, src_ip_f, dst_ip_f, svc_key,
                  ref_key=None, v6=None) -> torch.Tensor:
    """The lanes' interval rows, (B, 8) int32 (lane_rows' iv)."""
    return lane_rows(drs, src_ip_f, dst_ip_f, svc_key, ref_key, v6)[0]


def shard_offsets(hit_combine=None) -> tuple[int, int]:
    """The global index of the tables' first word per direction, which the
    kernels add to emit global rule indices: (0, 0) on one card (no
    combine, the whole table), else the combine's w0 (host ints, fixed
    per rule shard: no read-back)."""
    return (0, 0) if hit_combine is None else tuple(hit_combine.w0)


# ---------------------------------------------------------------------------
# Incremental membership deltas (match.py:620-723)
# ---------------------------------------------------------------------------


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (u32 words as int32 bits)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _delta_lane_match(ip_f: torch.Tensor, dt: DeltaTable, i: int,
                      wide=None) -> torch.Tensor:
    """Lanes slot i covers (match.py:628).  Without `wide` the narrow test:
    lo_f and hi_f are sign-flipped, so the compares are int32 ones.  With
    wide = (xw (B, 4), is6) the family-aware one: a v4 slot covers v4 lanes
    on the narrow column, a v6 slot (fam 1) v6 lanes whose words lie in
    [lo6_w, hi6_w] lexicographically."""
    m4 = (ip_f >= dt.lo_f[i]) & (ip_f <= dt.hi_f[i])
    if wide is None:
        return m4
    xw, is6 = wide
    m4 = m4 & (is6 == 0) & (dt.fam[i] == 0)
    m6 = ((is6 != 0) & (dt.fam[i] == 1)
          & _lex_le4(dt.lo6_w[i][None, :], xw)
          & _lex_le4(xw, dt.hi6_w[i][None, :]))
    return m4 | m6


def _delta_matches(ip_f: torch.Tensor, dt: DeltaTable, n: int,
                   wide=None) -> torch.Tensor:
    """(B,) lanes x the first n slots -> (B, n) bool, _delta_lane_match of
    every slot at once (the v6 ranges compared as _key2 pairs)."""
    m4 = ((ip_f[:, None] >= dt.lo_f[None, :n])
          & (ip_f[:, None] <= dt.hi_f[None, :n]))
    if wide is None:
        return m4
    xw, is6 = wide
    v6 = (is6 != 0)[:, None]
    fam6 = (dt.fam[:n] == 1)[None, :]
    xk = _key2(xw)[:, None, :]
    m6 = (_le2(_key2(dt.lo6_w[:n])[None, :, :], xk)
          & _le2(xk, _key2(dt.hi6_w[:n])[None, :, :]))
    return torch.where(v6, fam6 & m6, ~fam6 & m4)


def _patch_rows_m(rows: torch.Tensor, m: torch.Tensor, dt: DeltaTable,
                  masks: torch.Tensor) -> torch.Tensor:
    """Apply slots 0..n-1 in order to rows (B, W) int32, m (B, n) saying
    which slots cover each lane: a set slot ORs its mask in, a clear slot
    clears it, so a later slot wins on the bits both touch."""
    n = m.shape[1]
    sign = dt.sign[:n]
    sets = m & (sign > 0)[None, :]
    clears = m & (sign < 0)[None, :]
    for i in range(n):
        mask = masks[i][None, :]
        rows = torch.where(sets[:, i, None], rows | mask, rows)
        rows = torch.where(clears[:, i, None], rows & ~mask, rows)
    return rows


def _patch_rows(rows: torch.Tensor, ip_f: torch.Tensor, dt: DeltaTable,
                masks: torch.Tensor, n: int, wide=None) -> torch.Tensor:
    """The n active delta slots applied to gathered incidence rows (B, W)
    of lanes probed with ip_f (match.py:_patch_rows; wide as in
    _delta_lane_match)."""
    if n <= 0:
        return rows
    return _patch_rows_m(rows, _delta_matches(ip_f, dt, n, wide), dt, masks)


def _patch_iso(bit: torch.Tensor, ip_f: torch.Tensor, dt: DeltaTable,
               which: int, n: int, wide=None) -> torch.Tensor:
    """Isolation bits (B,) patched by the n active slots whose iso bit
    `which` is set (0: iso_in, 1: iso_out): of the slots covering a lane,
    the last one with a sign decides, as the in-order loop of
    match.py:_patch_iso does."""
    if n <= 0:
        return bit
    m = (_delta_matches(ip_f, dt, n, wide)
         & (((dt.iso[:n] >> which) & 1) == 1)[None, :]
         & (dt.sign[:n] != 0)[None, :])
    order = torch.arange(n, device=bit.device)
    last = torch.where(m, order, -1).max(dim=1).values
    val = (dt.sign[:n][last.clamp(min=0)] > 0).to(bit.dtype)
    return torch.where(last >= 0, val, bit)


def _agg_mask(mask_w: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 delta rule masks -> (..., W / AGG_BLOCK) int32
    aggregate masks: build_agg of each row."""
    s = mask_w.shape[-1] // AGG_BLOCK
    nz = (mask_w.reshape(*mask_w.shape[:-1], s, AGG_BLOCK) != 0).to(
        torch.int64)
    j = torch.arange(AGG_BLOCK, device=mask_w.device, dtype=torch.int64)
    return _to_i32((nz << j).sum(dim=-1))  # disjoint bits: sum == OR


def _patch_agg_m(rows: torch.Tensor, m: torch.Tensor, dt: DeltaTable,
                 masks: torch.Tensor) -> torch.Tensor:
    """Aggregate rows (B, S) patched by the set slots m marks: their
    aggregate masks ORed in.  Clear slots leave the aggregate as it is (a
    stale set bit only costs a candidate the full-width words disprove)."""
    n = m.shape[1]
    sets = m & (dt.sign[:n] > 0)[None, :]
    am = _agg_mask(masks[:n])
    for i in range(n):
        rows = torch.where(sets[:, i, None], rows | am[i][None, :], rows)
    return rows


def _patch_agg(rows: torch.Tensor, ip_f: torch.Tensor, dt: DeltaTable,
               masks: torch.Tensor, n: int, wide=None) -> torch.Tensor:
    """match.py:_patch_agg over the n active slots."""
    if n <= 0:
        return rows
    return _patch_agg_m(rows, _delta_matches(ip_f, dt, n, wide), dt, masks)


# The four address dimensions a delta patches: (interval-row column of iv,
# direction, dimension, probed with dst (1) or src (0), DeltaTable mask).
_DELTA_DIMS = ((0, "ingress", "at", 1, "at_in"),
               (1, "ingress", "peer", 0, "peer_in"),
               (3, "egress", "at", 0, "at_out"),
               (4, "egress", "peer", 1, "peer_out"))
_SIG_BITS = 62


def _sig_words(m: torch.Tensor) -> torch.Tensor:
    """(T, n) bool -> (T, ceil(n / 62)) int64, the slot set packed."""
    t, n = m.shape
    nw = -(-n // _SIG_BITS)
    if nw * _SIG_BITS > n:
        m = torch.cat([m, m.new_zeros(t, nw * _SIG_BITS - n)], dim=1)
    j = torch.arange(_SIG_BITS, device=m.device, dtype=torch.int64)
    return (m.view(t, nw, _SIG_BITS).to(torch.int64) << j).sum(dim=2)


def _sig_bits(sig: torch.Tensor, n: int) -> torch.Tensor:
    """_sig_words' inverse -> (U, n) bool."""
    j = torch.arange(_SIG_BITS, device=sig.device, dtype=torch.int64)
    return (((sig[:, :, None] >> j) & 1) != 0).reshape(sig.shape[0],
                                                        -1)[:, :n]


class DeltaOverlay(NamedTuple):
    """The lanes a pending delta slot covers, and what their second walk
    reads: the six incidence tables with the four address dimensions
    replaced by overlay tables of patched rows, and the lanes' interval
    rows pointing into them."""

    lanes: torch.Tensor  # (T,) int64 lane indices
    tabs: tuple  # six (rows, w) int32 tables in the kernels' order
    iv: torch.Tensor  # (T, 8) int32 interval rows into tabs
    # (in_at, in_peer, out_at, out_peer) patched aggregate rows (T, S), or
    # None when not asked for.
    aggs: Optional[tuple] = None


def _wide_pair(v6, lanes=None):
    """v6 = (src6w, dst6w, is6) -> the (src, dst) `wide` arguments of the
    delta tests, restricted to `lanes`; (None, None) without v6."""
    if v6 is None:
        return None, None
    s6, d6, is6 = v6
    if lanes is not None:
        s6, d6, is6 = s6[lanes], d6[lanes], is6[lanes]
    return (s6, is6), (d6, is6)


def delta_overlay(drs: DeviceRuleSet, iv: torch.Tensor, src_ip_f, dst_ip_f,
                  n: int, lanes: Optional[torch.Tensor] = None,
                  with_agg: bool = False, v6=None) -> Optional[DeltaOverlay]:
    """The overlay of the lanes that one of the n active delta slots covers
    (ingress probes appliedTo with dst and peer with src, egress the
    reverse, so a lane is touched when a slot covers its src or its dst);
    `lanes` restricts it to a given set.  Each dimension's overlay holds one
    patched row per distinct (interval row, set of covering slots), so its
    size follows the distinct addresses, not the lanes.  None when no lane
    is touched.  iv (B, 8) are the lanes' interval rows (interval_rows, or
    B3's); its svc columns are kept.  v6 = (src6w, dst6w, is6) makes the
    slot tests family-aware (_delta_lane_match)."""
    d = drs.ip_delta
    w_src, w_dst = _wide_pair(v6, lanes)
    m_src = _delta_matches(src_ip_f if lanes is None else src_ip_f[lanes],
                           d, n, w_src)
    m_dst = _delta_matches(dst_ip_f if lanes is None else dst_ip_f[lanes],
                           d, n, w_dst)
    if lanes is None:
        lanes = torch.nonzero((m_src | m_dst).any(dim=1)).flatten()
        m_src, m_dst = m_src[lanes], m_dst[lanes]
    if lanes.numel() == 0:
        return None
    iv_t = iv[lanes].clone()
    tabs = list(tables(drs))
    aggs = []
    for col, dname, dim, on_dst, mname in _DELTA_DIMS:
        tab = getattr(getattr(drs, dname), dim)
        masks = getattr(d, mname)
        key = torch.cat([iv_t[:, col:col + 1].to(torch.int64),
                         _sig_words(m_dst if on_dst else m_src)], dim=1)
        uk, inv = torch.unique(key, dim=0, return_inverse=True)
        m_u = _sig_bits(uk[:, 1:], n)
        rows = uk[:, 0]
        tabs[col] = _patch_rows_m(tab.inc[rows], m_u, d, masks).contiguous()
        iv_t[:, col] = inv.to(torch.int32)
        if with_agg:
            aggs.append(_patch_agg_m(tab.agg[rows], m_u, d, masks)[inv])
    return DeltaOverlay(lanes=lanes, tabs=tuple(tabs), iv=iv_t.contiguous(),
                        aggs=tuple(aggs) if with_agg else None)


def _patch_isos(drs: DeviceRuleSet, iso_in, iso_out, src_ip_f, dst_ip_f,
                lanes, n: int, v6=None):
    """In place: the isolation bits of `lanes` patched, iso_in on dst and
    iso_out on src (match.py:1277-1278)."""
    d = drs.ip_delta
    w_src, w_dst = _wide_pair(v6, lanes)
    iso_in[lanes] = _patch_iso(iso_in[lanes], dst_ip_f[lanes], d, 0, n, w_dst)
    iso_out[lanes] = _patch_iso(iso_out[lanes], src_ip_f[lanes], d, 1, n,
                                w_src)


def rewalk_hits(tabs, iv: torch.Tensor, fb: torch.Tensor,
                ov: Optional[DeltaOverlay], meta: StaticMeta, w0_in: int = 0,
                w0_out: int = 0) -> torch.Tensor:
    """Full-width first matches of the fallback lanes fb (compacted lane
    indices) through B1's wrapper -> (F, 6) int32: once on the tables for
    the lanes no delta covers, and once on the overlay for those of ov."""
    def b1(t, rows):
        return consumer.fused_hits(t, rows, meta.svcref, meta.in_phases,
                                   meta.out_phases, w0_in, w0_out)[:, :6]

    if ov is None:
        return b1(tabs, iv[fb])
    in_fb = torch.zeros(iv.shape[0], dtype=torch.bool, device=iv.device)
    in_fb[fb] = True
    plain = in_fb.clone()
    plain[ov.lanes] = False
    full = torch.zeros((iv.shape[0], 6), dtype=torch.int32, device=iv.device)
    idx = torch.nonzero(plain).flatten()
    if idx.numel():
        full[idx] = b1(tabs, iv[idx])
    sel = torch.nonzero(in_fb[ov.lanes]).flatten()
    if sel.numel():
        full[ov.lanes[sel]] = b1(ov.tabs, ov.iv[sel])
    return full[fb]


def walk_hits(tabs, iv: torch.Tensor, meta: StaticMeta, fused: bool,
              w0_in: int = 0, w0_out: int = 0) -> torch.Tensor:
    """Full-width first matches of the lanes' rows -> (B, 6) int32: B1's
    wrapper when fused (the kernel on the card), else the torch gathers
    and scan."""
    if fused:
        return consumer.fused_hits(tabs, iv, meta.svcref, meta.in_phases,
                                   meta.out_phases, w0_in, w0_out)[:, :6]
    (in_at, in_peer, in_svc), (out_at, out_peer, out_svc) = (
        consumer.gather_rows(tabs, iv, meta.svcref))
    return torch.stack(
        consumer.phase_hits(in_at & in_peer & in_svc, w0_in, meta.in_phases)
        + consumer.phase_hits(out_at & out_peer & out_svc, w0_out,
                              meta.out_phases), dim=1)



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
    delta_n: int = 0,
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
    default verdicts) and is ignored without pruning.

    hit_combine is the rule-axis seam (parallel/mesh.py): a callable that
    takes a (B, n) int32 tensor and returns its elementwise minimum over
    the rule shards, with an attribute w0 = (w0_in, w0_out), the global
    index of this shard's first word per direction (host ints).  The
    tables are then this shard's word slice, and the per-phase first
    matches are combined between the scan and the resolution.

    v6 = (src6w_f (B, 4), dst6w_f (B, 4), is6 (B,)) is the dual-stack lane
    extension: per-word sign-flipped v6 addresses and the family mask.  v6
    lanes take their ip dimensions' and isolation tables' rows in the v6
    sub-spaces (their v4 columns are ignored), so B1 and B2 read those rows
    unchanged; None is a v4 batch.

    delta_n > 0 applies the first delta_n slots of drs.ip_delta (the
    engine's pending membership deltas; a host int, so nothing is read
    back to find them): the lanes a slot covers are walked a second time
    on a DeltaOverlay (B1 again when fused) and written back, and their
    isolation bits patched (family-aware with v6)."""
    if meta.prune_budget > 0 and drs.ingress.at.agg is not None:
        return _classify_pruned(drs, src_ip_f, dst_ip_f, proto, dst_port,
                                meta=meta, fused=fused, svc_ref=svc_ref,
                                summary_only=summary_only,
                                hit_combine=hit_combine, delta_n=delta_n,
                                v6=v6)
    ing, eg = drs.ingress, drs.egress
    svc_key = (proto << 16) | dst_port
    ref_key = _svcref_key(svc_key, svc_ref) if meta.svcref else None
    iv, iso_in, iso_out = lane_rows(drs, src_ip_f, dst_ip_f, svc_key,
                                    ref_key, v6)
    w0_in, w0_out = shard_offsets(hit_combine)

    hits = walk_hits(tables(drs), iv, meta, fused, w0_in, w0_out)
    ov = (delta_overlay(drs, iv, src_ip_f, dst_ip_f, delta_n, v6=v6)
          if delta_n > 0 else None)
    if ov is not None:
        hits[ov.lanes] = walk_hits(ov.tabs, ov.iv, meta, fused, w0_in,
                                   w0_out)
        _patch_isos(drs, iso_in, iso_out, src_ip_f, dst_ip_f, ov.lanes,
                    delta_n, v6)
    if hit_combine is not None:
        hits = hit_combine(hits.contiguous())
    in_hits = (hits[:, 0], hits[:, 1], hits[:, 2])
    out_hits = (hits[:, 3], hits[:, 4], hits[:, 5])

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
                     summary_only: bool = False, hit_combine=None,
                     delta_n: int = 0, v6=None):
    """The two-level pruned classify (match.py:_classify_pruned), v4 and v6
    lanes, on one card or one rule shard.  An aggregate bit is set iff its incidence word is nonzero, so a
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
    nothing falls back.

    Under hit_combine the walk, its candidates and its fallback are this
    shard's own; the hits and the three observables are then combined in
    one call (match.py:1800-1815): skip as the minimum (no shard had a
    candidate), fb as one minus the minimum of 1 - fb (any shard fell
    back), cand as minus the minimum of -cand (the most on any shard).

    With delta_n > 0 the lanes a delta slot covers take the patched
    aggregate rows (set slots ORed in) into their AND, and their candidate
    scan (B2) and full-width fallback (B1) run a second time on their
    DeltaOverlay, whose rows are patched at full width (_patch_cand's
    effect); the others keep their launches."""
    ing, eg = drs.ingress, drs.egress
    B = src_ip_f.shape[0]
    K = meta.prune_budget
    svc_key = (proto << 16) | dst_port
    ref_key = _svcref_key(svc_key, svc_ref) if meta.svcref else None
    iv, iso_in, iso_out = lane_rows(drs, src_ip_f, dst_ip_f, svc_key,
                                    ref_key, v6)
    w0_in, w0_out = shard_offsets(hit_combine)

    ov = (delta_overlay(drs, iv, src_ip_f, dst_ip_f, delta_n, with_agg=True,
                        v6=v6)
          if delta_n > 0 else None)
    if ov is not None:
        _patch_isos(drs, iso_in, iso_out, src_ip_f, dst_ip_f, ov.lanes,
                    delta_n, v6)
    g, nc, ke = [], [], []
    for d, dd in enumerate((ing, eg)):
        # The aggregate AND of the direction's three dimension rows (the
        # svcref row ORed into svc).
        rows = [t.agg[iv[:, 3 * d + k].long()]
                for k, t in enumerate((dd.at, dd.peer, dd.svc))]
        if d and meta.svcref:
            rows[2] = rows[2] | dd.svc.agg[iv[:, 6].long()]
        g.append(rows[0] & rows[1] & rows[2])
        if ov is not None:
            # Touched lanes AND their patched at/peer aggregate rows.
            g[-1][ov.lanes] = (ov.aggs[2 * d] & ov.aggs[2 * d + 1]
                               & rows[2][ov.lanes])
        nc.append((g[-1] != 0).sum(dim=1, dtype=torch.int32))
        ke.append(min(K, dd.at.agg.shape[1]))
    live = (nc[0] > 0) | (nc[1] > 0)
    fb = (nc[0] > ke[0]) | (nc[1] > ke[1])
    if summary_only:
        any_live = 0
        fb = torch.zeros_like(fb)
    else:
        # One read-back: whether any lane has a candidate (else the whole
        # batch takes the default verdicts: no candidate scan, no
        # fallback) and how many lanes fall back.
        any_live, n_fb = torch.stack([live.any().long(), fb.sum()]).tolist()
    if any_live:
        # B2 selects each lane's ke lowest candidate superblocks and reads
        # their words from the tables (the kernel on the card when fused).
        scan = (pruned_consumer.pruned_hits if fused
                else pruned_consumer.pruned_hits_plain)
        hits = scan(g[0], g[1], iv, tables(drs), ke[0], ke[1], meta.svcref,
                    meta.in_phases, meta.out_phases, w0_in, w0_out)[:, :6]
        if ov is not None:
            # The touched lanes' candidates, read from their patched rows.
            hits[ov.lanes] = scan(
                g[0][ov.lanes].contiguous(), g[1][ov.lanes].contiguous(),
                ov.iv, ov.tabs, ke[0], ke[1], meta.svcref, meta.in_phases,
                meta.out_phases, w0_in, w0_out)[:, :6]
        if n_fb:
            # Full-width walk of the compacted fallback lanes: the function
            # B1 computes, so it goes through B1's wrapper (the kernel on
            # the card), written back lane for lane.
            idx = torch.nonzero(fb).flatten()
            hits[idx] = rewalk_hits(tables(drs), iv, idx, ov, meta, w0_in,
                                    w0_out)
    else:
        hits = torch.full((B, 6), BIG, dtype=torch.int32,
                          device=src_ip_f.device)
    skip = ((nc[0] == 0) & (nc[1] == 0)).to(torch.int32)
    cand = torch.maximum(nc[0], nc[1])
    fbi = fb.to(torch.int32)
    if hit_combine is not None:
        # The shard-local observables ride the hits' all-reduce.
        comb = hit_combine(torch.cat(
            [hits, torch.stack([skip, 1 - fbi, -cand], dim=1)], dim=1))
        hits, skip, fbi, cand = (comb[:, :6], comb[:, 6], 1 - comb[:, 7],
                                 -comb[:, 8])
    in_hits = (hits[:, 0], hits[:, 1], hits[:, 2])
    out_hits = (hits[:, 3], hits[:, 4], hits[:, 5])

    in_code, in_rule = _resolve(ing.action, in_hits, iso_in)
    out_code, out_rule = _resolve(eg.action, out_hits, iso_out)
    final = torch.where(out_code != ACT_ALLOW, out_code, in_code)
    return {
        "code": final,
        "egress_code": out_code,
        "egress_rule": out_rule,
        "ingress_code": in_code,
        "ingress_rule": in_rule,
        "prune_skip": skip > 0,
        "prune_fb": fbi > 0,
        "prune_cand": cand,
    }


def make_classifier(cps: CompiledPolicySet, device=None):
    """-> (fn(src_f, dst_f, proto, dport, v6=None) -> verdict dict, DRS).
    fn takes tensors or numpy arrays and classifies on `device`, like the
    JAX package's make_classifier (the unfused scan)."""
    drs, meta = to_device(cps, device)
    dev = drs.ingress.action.device

    def fn(src_f, dst_f, proto, dport, v6=None):
        args = (torch.as_tensor(x, device=dev)
                for x in (src_f, dst_f, proto, dport))
        if v6 is not None:
            v6 = tuple(torch.as_tensor(np.asarray(x, np.int32), device=dev)
                       for x in v6)
        return classify_batch(drs, *args, meta=meta, v6=v6)

    return fn, drs
