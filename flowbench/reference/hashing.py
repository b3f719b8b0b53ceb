"""FNV-1a with an xorshift avalanche over u32 words, on int64 tensors
holding u32 values: the datapath's flow and affinity hashes."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PRIME = 16777619
_BASIS = 0x811C9DC5
_SALT = 0x5CA1AB1E


def fnv_mix(words) -> torch.Tensor:
    h = None
    for w in words:
        w = w.long() & _M32
        h = torch.full_like(w, _BASIS) if h is None else h
        h = ((h ^ w) * _PRIME) & _M32
        h = h ^ (h >> 15)
    return h


def flow_hash(src, dst, proto, sport, dport) -> torch.Tensor:
    return fnv_mix([src, dst, ((proto.long() << 16) ^ sport.long()) & _M32,
                    (dport.long() & _M32) ^ _SALT])
