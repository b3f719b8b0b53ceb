"""B2, the pruned candidate consumer: per lane and direction, the AND of
three candidate-word matrices (the K lowest candidate superblocks of the
pruned classify, K * 32 words each), then per rule phase the lowest set
global rule index, against a per-element base matrix (32 * the global word
index of each candidate word).

Replaces the Pallas kernel antrea_tpu/ops/match.py:_pruned_consumer_call.
The CUDA kernel is csrc/pruned_consumer.cu; it is bound by memory, reading
the eight (B, K * 32) int32 matrices once and writing (B, 8) int32:
B * 8 * K * 32 * 4 + B * 32 bytes, 1.06 MB at K = 4 and B = 256 (0.32 us at
the H100's 3.35 TB/s, far below its launch overhead) and 135 MB at
B = 32768 (40 us).  The base matrices are a quarter of that traffic and
could be derived in the kernel from the candidate ids; the candidate
gathers feeding it stay torch indexing.  Both are later work.

pruned_hits() is the wrapper: on CPU tensors it runs pruned_plain(), the
plain PyTorch version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .consumer import _check, phase_first_from_base

# Kernel launches since the counter was last set to 0.  Only the CUDA
# launch in pruned_hits() adds to it.
launches = 0


def pruned_plain(mats_in, mats_out, in_phases, out_phases) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  mats_* = (at, peer, svc, base)
    (B, kw) int32 -> (B, 8) int32 [in0, ink, inb, out0, outk, outb, 0, 0]."""
    ia, ip, is_, bi = mats_in
    oa, op, os_, bo = mats_out
    hin = phase_first_from_base(ia & ip & is_, bi, in_phases)
    hout = phase_first_from_base(oa & op & os_, bo, out_phases)
    z = torch.zeros_like(hin[0])
    return torch.stack([*hin, *hout, z, z], dim=1)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("pruned_consumer").b2_pruned_consumer
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pruned_hits(mats_in, mats_out, in_phases, out_phases) -> torch.Tensor:
    """The candidate matrices of both directions (4 x (B, kw_in) and
    4 x (B, kw_out) int32: at, peer, svc words and the base matrix) ->
    (B, 8) int32 hits [in0, ink, inb, out0, outk, outb, 0, 0].
    CPU tensors: the plain version.  CUDA tensors: the B2 kernel."""
    global launches
    dev = mats_in[0].device
    b = mats_in[0].shape[0]
    kw_in = _check(mats_in, b, dev, "ingress")
    kw_out = _check(mats_out, b, dev, "egress")
    if dev.type == "cpu":
        return pruned_plain(mats_in, mats_out, in_phases, out_phases)
    if dev.type != "cuda":
        raise ValueError(f"pruned_hits runs on cpu or cuda tensors, not {dev}")
    out = torch.empty((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    (in_n0, in_nk, _), (out_n0, out_nk, _) = in_phases, out_phases
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(
        *(m.data_ptr() for m in (*mats_in, *mats_out)), out.data_ptr(),
        b, kw_in, kw_out, in_n0, in_nk, out_n0, out_nk, stream)
    if rc != 0:
        raise RuntimeError(f"B2 pruned consumer launch failed: cudaError {rc}")
    launches += 1
    return out
