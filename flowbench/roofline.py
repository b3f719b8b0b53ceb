"""The bytes that a call of the classify kernels must move, counted from
the call's own inputs: the kernel's least time is those bytes over the
card's HBM rate (every kernel of the step is bound by bytes, not
operations).  Frozen copies of chip_smoke.py's b3_work (B3, the one-pass
kernel) and of its rows-once count for B1 (the consumer kernel), with the
candidate choice of ops/pruned_consumer.candidate_ids.  They read the
layout of the engine's tables (superblocks of 32 words, 128-byte candidate
blocks, the lane rows B3 reads and writes): a change of that layout needs
these counts re-made."""

from __future__ import annotations

import torch

_BLOCK_BYTES = 128  # one candidate superblock row: 32 words


def candidate_ids(g: torch.Tensor, ke: int):
    """Aggregate AND rows g (B, S) -> the ke lowest superblocks whose
    aggregate word is nonzero, as (ids clipped to S-1, valid)."""
    S = g.shape[1]
    ids = torch.arange(S, dtype=torch.int32, device=g.device)
    score = torch.where(g != 0, ids, S)
    cand = torch.topk(score, ke, dim=1, largest=False, sorted=True).values
    return cand.clamp(max=S - 1).long(), cand < S


def b3_bytes(agg, bounds, iso_bounds, svcref: bool, k: int, iv_miss,
             b: int) -> int:
    """Rows-once bytes of a resolving B3 call over b lanes: every lane's 29
    input and 44 output words, each bounds array once, and each distinct
    aggregate row and candidate block (table, row, superblock) that the
    miss lanes (their interval rows iv_miss) read, once."""
    iv = iv_miss.long()
    s = [agg[0].shape[1], agg[3].shape[1]]
    dims = [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (5, 5)]
    if svcref:
        dims.append((5, 6))  # (table, iv column): the svcref row
    once = b * (29 + 44) * 4
    once += sum(t.shape[0] * 4 for t in (*bounds, *iso_bounds))
    blocks = 0
    for d in (0, 1):
        cols = [(t, c) for t, c in dims if t // 3 == d]
        r = [agg[t][iv[:, c]] for t, c in cols]
        g = r[0] & r[1] & (r[2] | r[3] if len(r) == 4 else r[2])
        cand, valid = candidate_ids(g, min(k, s[d]))
        for t, c in cols:
            key = iv[:, c, None] * s[d] + cand
            blocks += int(torch.unique(key[valid]).numel())
    for t in range(6):
        cs = [c for tt, c in dims if tt == t]
        once += int(torch.unique(iv[:, cs]).numel()) * s[t // 3] * 4
    return once + blocks * _BLOCK_BYTES


def b1_bytes(tabs, iv, svcref: bool) -> int:
    """Rows-once bytes of a B1 call: each distinct (table, row) of the
    lanes' interval rows once at its table's width, plus the lanes' iv and
    output rows (8 words each)."""
    cols = [(0,), (1,), (2,), (3,), (4,), (5, 6) if svcref else (5,)]
    once = iv.shape[0] * 8 * 4 * 2
    for c, t in zip(cols, tabs):
        once += int(torch.unique(iv[:, list(c)]).numel()) * t.shape[1] * 4
    return once
