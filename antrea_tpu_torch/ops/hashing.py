"""FNV-1a flow hashing (endpoint selection, conntrack and affinity slots).

The same bits as the JAX package's hashing.fnv_mix/flow_hash: endpoint
choice and cache slots are part of verdict parity.  torch's CPU uint32 has
no shifts or compares, so the arithmetic runs in int64 masked to 32 bits.

Inputs are int32 (or int64) tensors whose low 32 bits are the u32 words.
Outputs are int64 tensors holding the u32 hash value in [0, 2**32).
"""

from __future__ import annotations

import torch

_FNV_PRIME = 16777619
_FNV_BASIS = 0x811C9DC5
_U32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32/int64 tensor -> int64 tensor of its low 32 bits (the u32 view)."""
    return x.to(torch.int64) & _U32


def fnv_mix(words) -> torch.Tensor:
    """FNV-1a over a sequence of u32 word tensors, with an xorshift after
    each word -> int64 u32 hash."""
    h = None
    for w in words:
        w = u32(w)
        if h is None:
            h = torch.full_like(w, _FNV_BASIS)
        h = ((h ^ w) * _FNV_PRIME) & _U32
        h = h ^ (h >> 15)
    return h


def flow_hash(src, dst, proto, sport, dport, salt=0x5CA1AB1E) -> torch.Tensor:
    """5-tuple hash (raw, not sign-flipped, addresses) -> int64 u32."""
    return fnv_mix([
        src, dst,
        ((u32(proto) << 16) & _U32) ^ u32(sport),
        u32(dport) ^ salt,
    ])


def flow_hash_wide(addr_cols, proto, sport, dport,
                   salt=0x5CA1AB1E) -> torch.Tensor:
    """Dual-stack 5-tuple hash: the 8 address words of both endpoints in
    the wide word form (sign-flipped int32 is fine: their u32 bits are
    hashed, as in the JAX package) then the proto/port words -> int64
    u32."""
    return fnv_mix([
        *addr_cols,
        ((u32(proto) << 16) & _U32) ^ u32(sport),
        u32(dport) ^ salt,
    ])
