"""B1, the fused incidence consumer: per lane, AND of the three gathered
incidence rows of each direction, then the lowest set global rule index in
each of the three rule phases.

Replaces the Pallas kernel antrea_tpu/ops/match.py:_consumer_call (with its
_phase_scan_tile and shard-aware _phase_scan_tile_dyn bodies).  The CUDA
kernel is csrc/consumer.cu; it is bound by memory, reading
B * (3 * w_in + 3 * w_out) * 4 bytes once (9.6 MB at B = 256 and the
100k-rule widths 1866/1260: 2.9 us at the H100's 3.35 TB/s).  The row
gathers that feed it stay torch indexing and triple that traffic; moving
the gather into the kernel is the next step for its speed.

fused_hits() is the wrapper: on CPU tensors it runs phase_hits(), the plain
PyTorch version (the CPU tests, and the reference the kernel is held to on
the card); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

BIG = 1 << 30
_U32 = 0xFFFFFFFF

# Kernel launches since the counter was last set to 0 (the main-path proof
# chip_smoke.py reads).  Only the CUDA launch in fused_hits() adds to it.
launches = 0

# De Bruijn table: trailing-zero count of a 32-bit power of two p is
# _DEBRUIJN[((p * 0x077CB531) mod 2**32) >> 27].
_DEBRUIJN = (0, 1, 28, 2, 29, 14, 24, 3, 30, 22, 20, 15, 25, 17, 4, 8,
             31, 27, 13, 23, 21, 19, 16, 7, 26, 12, 18, 6, 11, 5, 10, 9)


def _phase_bounds(phases) -> tuple[tuple[int, int], ...]:
    n0, nk, _nb = phases
    return ((0, n0), (n0, n0 + nk), (n0 + nk, BIG))


def phase_first_from_base(match: torch.Tensor, base: torch.Tensor,
                          phases) -> tuple:
    """match (..., n) int32 words (u32 bits); base, broadcastable to it,
    the global rule index of each word's bit 0 (32 * global word index) ->
    per phase the lowest set global rule index, 3 x (...) int32 (BIG =
    none).  The plain scan that B1, B2 and B3 compute (the JAX package's
    _phase_first_from_base; _phase_hits is its per-column-base case).
    Works in int64 masked to 32 bits: torch's CPU uint32 has no shifts."""
    dev = match.device
    base = base.to(torch.int64)
    m = match.to(torch.int64) & _U32
    table = torch.tensor(_DEBRUIJN, dtype=torch.int64, device=dev)
    one = torch.ones_like(base)
    out = []
    for lo, hi in _phase_bounds(phases):
        k_lo = (lo - base).clamp(0, 32)
        k_hi = (hi - base).clamp(0, 32)
        mw = m & (((one << k_hi) - 1) & ~((one << k_lo) - 1))
        lsb = mw & -mw
        tz = table[((lsb * 0x077CB531) & _U32) >> 27]
        v = torch.where(mw == 0, BIG, base + tz)
        out.append(v.min(dim=-1).values.to(torch.int32))
    return tuple(out)


def phase_hits(match: torch.Tensor, w0: int, phases) -> tuple:
    """match (B, W) int32 words (u32 bits) of global words [w0, w0 + W) ->
    per-phase lowest set global rule index, 3 x (B,) int32 (BIG = none).
    The plain version of the kernel's scan (match.py:_phase_hits)."""
    base = (w0 + torch.arange(match.shape[1], device=match.device,
                              dtype=torch.int64)) * 32
    return phase_first_from_base(match, base, phases)


def consumer_plain(rows_in, rows_out, in_phases, out_phases,
                   w0_in: int = 0, w0_out: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, 8) int32
    [in0, ink, inb, out0, outk, outb, 0, 0]."""
    ia, ip, is_ = rows_in
    oa, op, os_ = rows_out
    hin = phase_hits(ia & ip & is_, w0_in, in_phases)
    hout = phase_hits(oa & op & os_, w0_out, out_phases)
    z = torch.zeros_like(hin[0])
    return torch.stack([*hin, *hout, z, z], dim=1)


def _check(rows, b: int, dev: torch.device, what: str) -> int:
    w = rows[0].shape[1] if rows[0].dim() == 2 else -1
    for r in rows:
        if r.dtype != torch.int32:
            raise TypeError(f"{what} rows must be int32, got {r.dtype}")
        if r.device != dev:
            raise ValueError(f"{what} rows must all lie on {dev}")
        if r.dim() != 2 or r.shape != (b, w):
            raise ValueError(f"{what} rows must all be ({b}, w), got "
                             f"{tuple(r.shape)}")
        if not r.is_contiguous():
            raise ValueError(f"{what} rows must be contiguous")
    if w < 1:
        raise ValueError(f"{what} rows need at least one word")
    return w


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("consumer").b1_consumer
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_hits(rows_in, rows_out, in_phases, out_phases,
               w0_in: int = 0, w0_out: int = 0) -> torch.Tensor:
    """The six gathered row matrices (3 x (B, w_in), 3 x (B, w_out) int32)
    -> (B, 8) int32 hits [in0, ink, inb, out0, outk, outb, 0, 0].
    CPU tensors: the plain version.  CUDA tensors: the B1 kernel."""
    global launches
    dev = rows_in[0].device
    b = rows_in[0].shape[0]
    w_in = _check(rows_in, b, dev, "ingress")
    w_out = _check(rows_out, b, dev, "egress")
    if dev.type == "cpu":
        return consumer_plain(rows_in, rows_out, in_phases, out_phases,
                              w0_in, w0_out)
    if dev.type != "cuda":
        raise ValueError(f"fused_hits runs on cpu or cuda tensors, not {dev}")
    out = torch.empty((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    (in_n0, in_nk, _), (out_n0, out_nk, _) = in_phases, out_phases
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(
        *(r.data_ptr() for r in (*rows_in, *rows_out)), out.data_ptr(),
        b, w_in, w_out, int(w0_in), int(w0_out), in_n0, in_nk, out_n0,
        out_nk, stream)
    if rc != 0:
        raise RuntimeError(f"B1 consumer launch failed: cudaError {rc}")
    launches += 1
    return out
