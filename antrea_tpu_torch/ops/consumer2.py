"""S1, the study's two-input consumer: per lane, the lowest set global rule
index in each of the three rule phases of two already-ANDed incidence
matrices, one per direction.

Replaces the Pallas kernel `consumer2` of bench_cold_study.py:129 (case 4
of the cold-path study: the six interval rows gathered and ANDed in the
framework, then a two-input phase scan).  The CUDA kernel is
csrc/consumer2.cu, B1's phase scan without the AND; it is bound by memory,
reading B * (w_in + w_out) * 4 bytes once (410 MB at B = 32768 and the
100k-rule widths 1866/1260: 0.122 ms at the H100's 3.35 TB/s).  No PyTorch
call computes it.

and_hits() is the wrapper: on CPU tensors it runs and_hits_plain(), the
plain PyTorch version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .consumer import phase_hits

# Kernel launches since the counter was last set to 0.  Only the CUDA
# launch in and_hits() adds to it.
launches = 0


def and_hits_plain(m_in, m_out, in_phases, out_phases) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, w_in) and (B, w_out) int32
    ANDed rows -> (B, 8) int32 [in0, ink, inb, out0, outk, outb, 0, 0]."""
    hin = phase_hits(m_in, 0, in_phases)
    hout = phase_hits(m_out, 0, out_phases)
    z = torch.zeros_like(hin[0])
    return torch.stack([*hin, *hout, z, z], dim=1)


def _check(rows, b: int, dev: torch.device, what: str) -> int:
    """Row matrices (B, w) int32, contiguous, on dev -> w."""
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
        fn = _build.load("consumer2").s1_consumer2
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def and_hits(m_in, m_out, in_phases, out_phases) -> torch.Tensor:
    """The two ANDed row matrices ((B, w_in) and (B, w_out) int32) -> (B, 8)
    int32 hits [in0, ink, inb, out0, outk, outb, 0, 0].
    CPU tensors: the plain version.  CUDA tensors: the S1 kernel."""
    global launches
    dev = m_in.device
    b = m_in.shape[0]
    w_in = _check((m_in,), b, dev, "ingress")
    w_out = _check((m_out,), b, dev, "egress")
    if dev.type == "cpu":
        return and_hits_plain(m_in, m_out, in_phases, out_phases)
    if dev.type != "cuda":
        raise ValueError(f"and_hits runs on cpu or cuda tensors, not {dev}")
    out = torch.empty((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    (in_n0, in_nk, _), (out_n0, out_nk, _) = in_phases, out_phases
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(m_in.data_ptr(), m_out.data_ptr(), out.data_ptr(), b,
                   w_in, w_out, in_n0, in_nk, out_n0, out_nk, stream)
    if rc != 0:
        raise RuntimeError(f"S1 consumer2 launch failed: cudaError {rc}")
    with _build.LOCK:
        launches += 1
    return out
