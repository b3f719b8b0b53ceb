"""B2, the pruned candidate consumer: per lane and direction, the ke lowest
candidate superblocks of the lane's aggregate AND row, the AND of their
words in the three incidence rows at the lane's interval rows, then per rule
phase the lowest set global rule index.

Replaces the Pallas kernel antrea_tpu/ops/match.py:_pruned_consumer_call and
the candidate gather that feeds it (cand_mats, match.py:1656-1700: top_k,
the candidate-word gathers, the zeroed fill words, the base matrix).  The
CUDA kernel is csrc/pruned_consumer.cu: one warp per lane and direction
selects its candidates by a ballot over the aggregate AND and fetches each
candidate's 128-byte block per row itself (the scan of
csrc/candidate_scan.cuh, shared with B3), so no candidate matrix is
written.  It is bound by bytes: the two aggregate AND rows and, per
direction, 128 B of each dimension row for each candidate scanned (at most
6 * K * 128 B = 3 KB a lane at K = 4), each distinct (table, row,
superblock) read once from device memory.

pruned_hits() is the wrapper: on CPU tensors it runs pruned_hits_plain()
(candidate_mats, then pruned_plain); on CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .consumer import check_tables, launch, phase_first_from_base

# Words per superblock: one aggregate bit per incidence word, one aggregate
# word per 32-word block (ops/match.AGG_BLOCK).
AGG_BLOCK = 32

# Kernel launches since the counter was last set to 0.  Only the CUDA
# launch in pruned_hits() adds to it.
launches = 0


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


def candidate_mats(tabs3, g, iv3, iv_ref, ke: int, w0: int = 0) -> list:
    """pruned_plain's four (B, ke*32) int32 inputs of one direction: the
    candidate words of the three tables tabs3 at the interval rows iv3 (the
    svcref row iv_ref, or None, ORed into svc; fill candidates zeroed in one
    dimension so the AND kills them) and their base matrix."""
    cand, valid = candidate_ids(g, ke)
    B = g.shape[0]

    def words(t, r):
        return candidate_blocks(t, r.long().clamp(0, t.shape[0] - 1), cand)

    ca, cp, cs = (words(t, r) for t, r in zip(tabs3, iv3))
    if iv_ref is not None:
        cs = cs | words(tabs3[2], iv_ref)
    ca = torch.where(valid[:, :, None], ca, 0)
    return [ca.reshape(B, -1), cp.reshape(B, -1), cs.reshape(B, -1),
            candidate_base(cand, w0)]


def pruned_plain(mats_in, mats_out, in_phases, out_phases) -> torch.Tensor:
    """The AND and phase scan of gathered candidate matrices in plain
    PyTorch.  mats_* = (at, peer, svc, base) (B, kw) int32 -> (B, 8) int32
    [in0, ink, inb, out0, outk, outb, 0, 0]."""
    ia, ip, is_, bi = mats_in
    oa, op, os_, bo = mats_out
    hin = phase_first_from_base(ia & ip & is_, bi, in_phases)
    hout = phase_first_from_base(oa & op & os_, bo, out_phases)
    z = torch.zeros_like(hin[0])
    return torch.stack([*hin, *hout, z, z], dim=1)


def pruned_hits_plain(g_in, g_out, iv, tabs, ke_in: int, ke_out: int,
                      svcref: bool, in_phases, out_phases, w0_in: int = 0,
                      w0_out: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, 8) int32."""
    mats = [candidate_mats(tabs[3 * d:3 * d + 3], g,
                           [iv[:, 3 * d + k] for k in range(3)],
                           iv[:, 6] if d and svcref else None, ke, w0)
            for d, g, ke, w0 in ((0, g_in, ke_in, w0_in),
                                 (1, g_out, ke_out, w0_out))]
    return pruned_plain(mats[0], mats[1], in_phases, out_phases)


def _check(g_in, g_out, iv, tabs, ke_in, ke_out) -> tuple[int, int, int]:
    """check_tables, and the aggregate AND rows: (B, S) int32 contiguous,
    S * 32 the direction's table width, 1 <= ke <= S.  -> (B, S_in,
    S_out)."""
    b, w_in, w_out = check_tables(tabs, iv, "B2")
    for g, w, ke, what in ((g_in, w_in, ke_in, "g_in"),
                           (g_out, w_out, ke_out, "g_out")):
        if g.dtype != torch.int32:
            raise TypeError(f"B2 {what} must be int32, got {g.dtype}")
        if g.device != iv.device:
            raise ValueError(f"B2 inputs must all lie on {iv.device}")
        if g.dim() != 2 or g.shape[0] != b or g.shape[1] * AGG_BLOCK != w:
            raise ValueError(f"B2 {what} must be ({b}, {w // AGG_BLOCK}) "
                             f"for tables of width {w}, got "
                             f"{tuple(g.shape)}")
        if not g.is_contiguous():
            raise ValueError(f"B2 {what} must be contiguous")
        if not 1 <= ke <= g.shape[1]:
            raise ValueError(f"B2 ke must lie in [1, {g.shape[1]}], got {ke}")
    return b, g_in.shape[1], g_out.shape[1]


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("pruned_consumer").b2_pruned_consumer
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pruned_hits(g_in, g_out, iv, tabs, ke_in: int, ke_out: int,
                svcref: bool, in_phases, out_phases, w0_in: int = 0,
                w0_out: int = 0) -> torch.Tensor:
    """The aggregate AND rows g_in (B, S_in) and g_out (B, S_out) int32, the
    lanes' interval rows iv (B, 8) int32 (ops/consumer.fused_hits' layout),
    the six incidence tables (rows, S * 32) int32, and ke candidates per
    direction -> (B, 8) int32 hits [in0, ink, inb, out0, outk, outb, 0, 0]
    over each lane's ke lowest candidate superblocks.  CPU tensors: the
    plain version.  CUDA tensors: the B2 kernel."""
    global launches
    b, s_in, s_out = _check(g_in, g_out, iv, tabs, ke_in, ke_out)
    dev = iv.device
    if dev.type == "cpu":
        return pruned_hits_plain(g_in, g_out, iv, tabs, ke_in, ke_out,
                                 svcref, in_phases, out_phases, w0_in, w0_out)
    if dev.type != "cuda":
        raise ValueError(f"pruned_hits runs on cpu or cuda tensors, not {dev}")
    out = torch.empty((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    (in_n0, in_nk, _), (out_n0, out_nk, _) = in_phases, out_phases
    launch("B2 pruned consumer", _kernel(),
           [t.data_ptr() for t in (g_in, g_out, iv, *tabs, out)],
           [b, s_in, s_out, ke_in, ke_out, w0_in, w0_out, in_n0, in_nk,
            out_n0, out_nk, bool(svcref), *(t.shape[0] for t in tabs)], dev)
    with _build.LOCK:
        launches += 1
    return out
