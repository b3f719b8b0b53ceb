"""B1, the fused incidence consumer: per lane, the AND of each direction's
three incidence rows, read from the tables at the lane's interval rows,
then the lowest set global rule index in each of the three rule phases.

Replaces the Pallas kernel antrea_tpu/ops/match.py:_consumer_call (with its
_phase_scan_tile and shard-aware _phase_scan_tile_dyn bodies) and the six
row gathers that feed it (match.py:1246-1270).  The CUDA kernel is
csrc/consumer.cu.  It takes the six incidence tables as they lie on the
device and the lanes' interval rows, so no (B, w) row matrix is written:
the framework's gathers used to write every lane's rows and the kernel
read them back.  It is bound by bytes: each distinct (table, row) once
from device memory (the rows many lanes share come from L2 after that),
at most B * (3 * w_in + 3 * w_out) * 4 bytes (9.6 MB at B = 256 and the
100k-rule widths 1866/1260: 2.9 us at the H100's 3.35 TB/s).  At large B
the lanes' rows stream from L2, whose rate bounds it there.  Rows of any
width and alignment are read with the widest loads their address allows.

fused_hits() is the wrapper: on CPU tensors it runs fused_hits_plain(), the
plain PyTorch version (torch indexing of the rows, then consumer_plain; the
CPU tests, and the reference the kernel is held to on the card); on CUDA
tensors it launches the kernel or raises.
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
    """The AND and phase scan of gathered rows (3 x (B, w_in),
    3 x (B, w_out) int32), in plain PyTorch -> (B, 8) int32
    [in0, ink, inb, out0, outk, outb, 0, 0]."""
    ia, ip, is_ = rows_in
    oa, op, os_ = rows_out
    hin = phase_hits(ia & ip & is_, w0_in, in_phases)
    hout = phase_hits(oa & op & os_, w0_out, out_phases)
    z = torch.zeros_like(hin[0])
    return torch.stack([*hin, *hout, z, z], dim=1)


def gather_rows(tabs, iv: torch.Tensor, svcref: bool) -> tuple:
    """The torch gathers the kernel replaces: the six tables' rows at the
    interval rows iv (B, 8) (clamped to each table, as the JAX gather
    clamps), the egress svc row ORed with the row at iv[:, 6] when svcref.
    -> ((in_at, in_peer, in_svc), (out_at, out_peer, out_svc)) (B, w)."""
    def row(t, col):
        return t[iv[:, col].long().clamp(0, t.shape[0] - 1)]

    rows = [row(t, k) for k, t in enumerate(tabs)]
    if svcref:
        rows[5] = rows[5] | row(tabs[5], 6)
    return tuple(rows[:3]), tuple(rows[3:])


def fused_hits_plain(tabs, iv, svcref, in_phases, out_phases,
                     w0_in: int = 0, w0_out: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> (B, 8) int32."""
    rows_in, rows_out = gather_rows(tabs, iv, svcref)
    return consumer_plain(rows_in, rows_out, in_phases, out_phases, w0_in,
                          w0_out)


def check_tables(tabs, iv: torch.Tensor, what: str) -> tuple[int, int, int]:
    """Dtype, device, shape and contiguity of a kernel's six incidence
    tables (ingress at/peer/svc, egress at/peer/svc: (rows, w) int32, the
    widths of a direction's three tables equal) and its interval rows iv
    (B, 8) int32.  -> (B, w_in, w_out)."""
    if len(tabs) != 6:
        raise ValueError(f"{what} takes six incidence tables")
    dev = iv.device
    if iv.dtype != torch.int32:
        raise TypeError(f"{what} iv must be int32, got {iv.dtype}")
    if iv.dim() != 2 or iv.shape[1] != 8:
        raise ValueError(f"{what} iv must be (B, 8), got {tuple(iv.shape)}")
    if not iv.is_contiguous():
        raise ValueError(f"{what} iv must be contiguous")
    for t in tabs:
        if t.dtype != torch.int32:
            raise TypeError(f"{what} tables must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what} tables and iv must all lie on {dev}")
        if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
            raise ValueError(f"{what} tables must be (rows, w) with rows and "
                             f"w at least 1, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} tables must be contiguous")
    w_in, w_out = tabs[0].shape[1], tabs[3].shape[1]
    if any(t.shape[1] != w_in for t in tabs[:3]) or any(
            t.shape[1] != w_out for t in tabs[3:]):
        raise ValueError(f"{what}: the three tables of a direction must have "
                         f"one width, got {[t.shape[1] for t in tabs]}")
    return iv.shape[0], w_in, w_out


def launch(name: str, fn, ptrs, ints, dev) -> None:
    """Call a kernel's C entry (void* const* ptrs, const int* ints, stream)
    on dev's current stream; raise if the launch was refused."""
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*(int(i) for i in ints))
    rc = fn(c_ptrs, c_ints, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("consumer").b1_consumer
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_hits(tabs, iv: torch.Tensor, svcref: bool, in_phases, out_phases,
               w0_in: int = 0, w0_out: int = 0) -> torch.Tensor:
    """The six incidence tables (DimTable.inc: ingress at/peer/svc
    (rows, w_in), egress at/peer/svc (rows, w_out) int32) and the lanes'
    interval rows iv (B, 8) int32 [in_at, in_peer, in_svc, out_at, out_peer,
    out_svc, svcref_row, 0] -> (B, 8) int32 hits [in0, ink, inb, out0, outk,
    outb, 0, 0].  svcref ORs the egress svc row at iv[:, 6] into the one at
    iv[:, 5].  CPU tensors: the plain version.  CUDA tensors: the B1
    kernel."""
    global launches
    b, w_in, w_out = check_tables(tabs, iv, "B1")
    dev = iv.device
    if dev.type == "cpu":
        return fused_hits_plain(tabs, iv, svcref, in_phases, out_phases,
                                w0_in, w0_out)
    if dev.type != "cuda":
        raise ValueError(f"fused_hits runs on cpu or cuda tensors, not {dev}")
    out = torch.empty((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    (in_n0, in_nk, _), (out_n0, out_nk, _) = in_phases, out_phases
    launch("B1 consumer", _kernel(),
           [t.data_ptr() for t in (*tabs, iv, out)],
           [b, w_in, w_out, w0_in, w0_out, in_n0, in_nk, out_n0, out_nk,
            bool(svcref), *(t.shape[0] for t in tabs)], dev)
    with _build.LOCK:
        launches += 1
    return out
