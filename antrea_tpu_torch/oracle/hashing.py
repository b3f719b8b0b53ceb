"""FNV-1a flow hashing in numpy, for the scalar twin (oracle/pipeline.py).

A copy of the JAX package's ops/hashing.py: the same bits must come out of
the scalar twin and the engine (endpoint selection and conntrack slots are
part of verdict parity).  The engine hashes with torch (ops/hashing.py,
int64 arithmetic masked to 32 bits, since torch's CPU uint32 has no shifts
or compares); the twin hashes host integers with numpy's uint32, so it keeps
this numpy form.  `xp` stays a parameter, as in the original, and is always
numpy here.
"""

from __future__ import annotations

import contextlib

import numpy as np

_FNV_PRIME = 16777619
_FNV_BASIS = 0x811C9DC5


def fnv_mix(words, xp=np):
    """FNV-1a over a sequence of u32 words -> u32 hash (array-shaped)."""
    # u32 wraparound is the point; keep numpy from warning about it.
    ctx = np.errstate(over="ignore") if xp is np else contextlib.nullcontext()
    with ctx:
        h = None
        for w in words:
            w = xp.asarray(w).astype(xp.uint32)
            if h is None:
                h = xp.full_like(w, _FNV_BASIS, dtype=xp.uint32)
            h = (h ^ w) * xp.uint32(_FNV_PRIME)
            # extra avalanche: xorshift
            h = h ^ (h >> xp.uint32(15))
    return h


def flow_hash(src, dst, proto, sport, dport, salt=0x5CA1AB1E, xp=np):
    """Symmetric-free 5-tuple hash used for endpoint selection + ct slots."""
    return fnv_mix(
        [src, dst, (xp.asarray(proto).astype(xp.uint32) << xp.uint32(16))
         ^ xp.asarray(sport).astype(xp.uint32),
         xp.asarray(dport).astype(xp.uint32) ^ xp.uint32(salt)],
        xp=xp,
    )


def flow_hash_wide(addr_cols, proto, sport, dport, salt=0x5CA1AB1E, xp=np):
    """Dual-stack 5-tuple hash: 8 address words (both endpoints in wide,
    v4-mapped word form — see utils/ip.key_to_words) + ports/proto.
    addr_cols is a sequence of 8 (B,)-shaped word arrays (sign-flipped i32
    is fine: the u32 view is hashed, identically on both twins)."""
    return fnv_mix(
        [*addr_cols,
         (xp.asarray(proto).astype(xp.uint32) << xp.uint32(16))
         ^ xp.asarray(sport).astype(xp.uint32),
         xp.asarray(dport).astype(xp.uint32) ^ xp.uint32(salt)],
        xp=xp,
    )
