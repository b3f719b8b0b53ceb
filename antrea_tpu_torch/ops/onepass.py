"""B3, the one-pass slow path: for every lane of a batch, the flow-cache
probe decode, the aggregate AND with its zero-AND skip and fallback flag,
the K lowest candidate superblocks and their first match per rule phase,
verdict resolution with the isolation bits, the ServiceLB overlay, the
cached/fresh image merge, and the forward and reply commit rows (with the
reply slot's flow hash), in one pass.

Replaces the Pallas kernel antrea_tpu/ops/match.py:_onepass_call in its
single-card resolve variant (resolve=True); the rule-sharded hits-only
variant (resolve=False) belongs to the mesh, which is not ported.  The
CUDA kernel is csrc/onepass.cu.  It is bound by bytes: per miss lane about
1.35 KB of lane inputs and aggregate rows at the 100k-rule widths, plus up
to 6 * K * 128 B = 3 KB of candidate rows (K = 4), plus 144 B of outputs,
which is about 0.6 GB and 0.18 ms at the H100's 3.35 TB/s for an all-miss
batch of 2**17 lanes; a hit lane costs about 0.34 KB.  The six (B, S)
aggregate matrices it reads are gathered by torch over the whole batch
(about 156 MB written and read again at B = 2**17); the kernel has the
interval rows and could gather them itself, which is later work.

onepass() is the wrapper: on CPU tensors it runs onepass_plain(), the plain
PyTorch version (a straight transcription of the kernel over all lanes);
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..compiler.compile import ACT_ALLOW, ACT_REJECT
from . import match
from .consumer import phase_first_from_base
from .pruned_consumer import candidate_mats

# Kernel launches since the counter was last set to 0.  Only the CUDA
# launch in onepass() adds to it.
launches = 0


class OnepassInputs(NamedTuple):
    """The per-lane inputs (int32, u32 words as int32 bits)."""

    pkt: torch.Tensor  # (B, 8) [src_f, dst_f, proto, sport, dport, pp, 0, 0]
    kr: torch.Tensor  # (B, 4) flow-cache key rows gathered at batch start
    prb: torch.Tensor  # (B, 4) [ts (at batch start), iso_in, iso_out, 0]
    mrow: torch.Tensor  # (B, 4) flow-cache meta rows gathered at batch start
    msk: torch.Tensor  # (B, 4) [valid, no_commit, fb_force, 0]
    lb: torch.Tensor  # (B, 8) [svc_idx, no_ep, dnat_ip_f, dnat_port, snat, dsr, 0, 0]
    # Aggregate rows, miss-masked: ingress at/peer/svc (B, S_in), then
    # egress at/peer/svc (B, S_out) with the svcref row ORed into svc.
    agg: tuple
    # (B, 8) interval rows [in_at, in_peer, in_svc, out_at, out_peer,
    # out_svc, svc_ref, 0]
    iv: torch.Tensor


class OnepassTables(NamedTuple):
    """The rule tables the kernel reads: six incidence tables (rows, S*32)
    in OnepassInputs.agg's order, and the two action vectors."""

    inc: tuple
    act_in: torch.Tensor
    act_out: torch.Tensor


class OnepassStatic(NamedTuple):
    """Shape constants of a call (plain ints)."""

    k: int  # candidate superblocks per lane and direction (prune budget)
    in_phases: tuple
    out_phases: tuple
    svcref: bool
    timeouts: tuple  # (tcp_syn, tcp_est, other_new, other_est)
    n_slots: int  # flow-cache slots (a power of two)
    pref_mask: int


def onepass_plain(x: OnepassInputs, tabs: OnepassTables, now: int,
                  gen_w: int, st: OnepassStatic, w0_in: int = 0,
                  w0_out: int = 0):
    """Plain PyTorch version of the kernel -> (main (B, 16), keys8 (B, 8),
    meta8 (B, 8), aux (B, 4)) int32, the columns of match.py:2136-2152:
    main [code, rule_in, rule_out, svc, dnat_ip_f, dnat_port, snat, dsr,
    committed, rev_ins, rev_slot, hit, est, rpl, ins, 0]; aux [skip, fb,
    cand, 0]."""
    from ..models import pipeline as pl  # the bit layouts live with the step

    src_f, dst_f, proto, sport, dport, pp = x.pkt[:, :6].unbind(1)
    kr, mr = x.kr, x.mrow
    valid = x.msk[:, 0] != 0
    nc = x.msk[:, 1] != 0
    fb_force = x.msk[:, 2] != 0

    # Probe decode: the _cache_lookup discipline on the gathered rows.
    kpg = kr[:, 3]
    pg_cur = proto | 0x100 | (gen_w << 9)
    pg_est = proto | 0x100 | (pl.GEN_ETERNAL << 9)
    pg_rpl = pg_est | pl.REPLY_BIT
    key_hit = ((kr[:, 0] == src_f) & (kr[:, 1] == dst_f) & (kr[:, 2] == pp)
               & ((kpg == pg_cur) | (kpg == pg_est) | (kpg == pg_rpl)))
    ts, iso_in, iso_out = x.prb[:, 0], x.prb[:, 1], x.prb[:, 2]
    tmo = st.timeouts
    if tmo[0] == tmo[1] == tmo[2] == tmo[3]:
        timeout = tmo[1]
    else:
        timeout = pl.entry_timeout((mr[:, 3] >> 29) & 1, proto, tmo)
    hit = key_hit & ((now - ts) <= timeout) & valid
    est = hit & ((kpg == pg_est) | (kpg == pg_rpl))
    rpl = hit & (kpg == pg_rpl)
    miss = ~hit & valid

    # Per direction: aggregate AND (non-miss lanes spawn no candidates),
    # the ke lowest candidate superblocks, their words, the first match.
    hits, ncs, kes = [], [], []
    for d, phases, w0 in ((0, st.in_phases, w0_in), (1, st.out_phases, w0_out)):
        a, p, s = x.agg[3 * d:3 * d + 3]
        ke = min(st.k, a.shape[1])
        g = torch.where(miss[:, None], a & p & s, 0)
        ca, cp, cs, base = candidate_mats(
            tabs.inc[3 * d:3 * d + 3], g, x.iv[:, 3 * d:3 * d + 3].unbind(1),
            x.iv[:, 6] if st.svcref and d == 1 else None, ke, w0)
        hits += phase_first_from_base(ca & cp & cs, base, phases)
        ncs.append((g != 0).sum(dim=1, dtype=torch.int32))
        kes.append(ke)
    skip = miss & (ncs[0] == 0) & (ncs[1] == 0)
    fb = miss & ((ncs[0] > kes[0]) | (ncs[1] > kes[1]) | fb_force)
    cand = torch.maximum(ncs[0], ncs[1])

    # Resolution from the actions at the clipped first-match indices.
    i0, ik, ib, o0, ok_, ob = hits
    na, nb = tabs.act_in.shape[0], tabs.act_out.shape[0]

    def act(tab, h, n):
        return tab[h.clamp(0, n - 1).long()]

    in_code, in_rule = match._resolve_from_actions(
        act(tabs.act_in, i0, na), act(tabs.act_in, ib, na), (i0, ik, ib),
        iso_in)
    out_code, out_rule = match._resolve_from_actions(
        act(tabs.act_out, o0, nb), act(tabs.act_out, ob, nb), (o0, ok_, ob),
        iso_out)
    cls_code = torch.where(out_code != ACT_ALLOW, out_code, in_code)

    # ServiceLB overlay (SvcReject precedes the policy tables): the fresh
    # image of each lane.
    svc_idx, no_ep, dnat_ip, dnat_port, snat_m, dsr_m = x.lb[:, :6].unbind(1)
    no_ep = no_ep != 0
    f_code = torch.where(no_ep, ACT_REJECT, cls_code).to(torch.int32)
    f_ri = torch.where(no_ep, pl.MISS, in_rule)
    f_ro = torch.where(no_ep, pl.MISS, out_rule)

    # Cached image decode and the hit/miss/default merge.
    c_code, c_svc, c_dport = pl._unpack_meta1(mr[:, 1])
    c_ri, c_ro = pl._unpack_rules(mr[:, 2])
    fwd_hit = hit & ~rpl

    def merge(cached, fresh, default, on=hit):
        return torch.where(on, cached, torch.where(miss, fresh, default))

    rows = pl._fused_pack_rows(
        src_f, dst_f, proto, sport, dport, pp, f_code, svc_idx, dnat_ip,
        dnat_port, snat_m, dsr_m, f_ri, f_ro, miss, nc, now, gen_w,
        st.n_slots, st.pref_mask)
    i32 = torch.int32
    main = torch.stack([
        merge(c_code, f_code, ACT_ALLOW), merge(c_ri, f_ri, pl.MISS),
        merge(c_ro, f_ro, pl.MISS), merge(c_svc, svc_idx, pl.MISS),
        merge(mr[:, 0], dnat_ip, dst_f), merge(c_dport, dnat_port, dport),
        merge((mr[:, 3] >> 31) & 1, snat_m, 0, fwd_hit),
        merge((mr[:, 3] >> 30) & 1, dsr_m, 0, fwd_hit),
        rows["committed"].to(i32), rows["rev_ins"].to(i32), rows["rev_slot"],
        hit.to(i32), est.to(i32), rpl.to(i32), rows["ins"].to(i32),
        torch.zeros_like(src_f)], dim=1).to(i32)
    aux = torch.stack([skip.to(i32), fb.to(i32), cand,
                       torch.zeros_like(cand)], dim=1)
    return main, rows["keys8"], rows["meta8"], aux


def _check(x: OnepassInputs, tabs: OnepassTables) -> tuple[int, int, int]:
    """Dtype, device, shape and contiguity checks -> (B, S_in, S_out)."""
    b = x.pkt.shape[0]
    dev = x.pkt.device
    s_in, s_out = x.agg[0].shape[-1], x.agg[3].shape[-1]
    want = [("pkt", x.pkt, (b, 8)), ("kr", x.kr, (b, 4)),
            ("prb", x.prb, (b, 4)), ("mrow", x.mrow, (b, 4)),
            ("msk", x.msk, (b, 4)), ("lb", x.lb, (b, 8)),
            ("iv", x.iv, (b, 8))]
    want += [(f"agg[{i}]", a, (b, s_in if i < 3 else s_out))
             for i, a in enumerate(x.agg)]
    want += [(f"inc[{i}]", t, (t.shape[0], 32 * (s_in if i < 3 else s_out)))
             for i, t in enumerate(tabs.inc)]
    want += [("act_in", tabs.act_in, (tabs.act_in.shape[0],)),
             ("act_out", tabs.act_out, (tabs.act_out.shape[0],))]
    if len(x.agg) != 6 or len(tabs.inc) != 6:
        raise ValueError("B3 takes six aggregate matrices and six tables")
    for name, t, shape in want:
        if t.dtype != torch.int32:
            raise TypeError(f"B3 input {name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"B3 inputs must all lie on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"B3 input {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"B3 input {name} must be contiguous")
    if s_in < 1 or s_out < 1 or min(tabs.act_in.shape[0],
                                    tabs.act_out.shape[0]) < 1:
        raise ValueError("B3 needs at least one superblock and one rule")
    return b, s_in, s_out


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("onepass").b3_onepass
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def onepass(x: OnepassInputs, tabs: OnepassTables, now: int, gen_w: int,
            st: OnepassStatic, w0_in: int = 0, w0_out: int = 0):
    """-> (main (B, 16), keys8 (B, 8), meta8 (B, 8), aux (B, 4)) int32, see
    onepass_plain.  CPU tensors: the plain version.  CUDA tensors: the B3
    kernel."""
    global launches
    b, s_in, s_out = _check(x, tabs)
    dev = x.pkt.device
    if dev.type == "cpu":
        return onepass_plain(x, tabs, now, gen_w, st, w0_in, w0_out)
    if dev.type != "cuda":
        raise ValueError(f"onepass runs on cpu or cuda tensors, not {dev}")
    outs = tuple(torch.empty((b, n), dtype=torch.int32, device=dev)
                 for n in (16, 8, 8, 4))
    if b == 0:
        return outs
    if st.k < 1 or st.n_slots & (st.n_slots - 1):
        raise ValueError("B3 needs k >= 1 and a power-of-two slot count")
    # The kernel reads the lane rows and writes the outputs 16 bytes at a
    # time.
    for t in (x.pkt, x.kr, x.prb, x.mrow, x.msk, x.lb, x.iv):
        if t.data_ptr() % 16:
            raise ValueError("B3 lane inputs must be 16-byte aligned")
    tmo = st.timeouts
    ptrs = [t.data_ptr() for t in (x.pkt, x.kr, x.prb, x.mrow, x.msk, x.lb,
                                   *x.agg, x.iv, *tabs.inc, tabs.act_in,
                                   tabs.act_out, *outs)]
    ints = [b, s_in, s_out, min(st.k, s_in), min(st.k, s_out),
            tabs.act_in.shape[0], tabs.act_out.shape[0], int(now),
            int(gen_w), int(w0_in), int(w0_out), st.in_phases[0],
            st.in_phases[1], st.out_phases[0], st.out_phases[1],
            int(bool(st.svcref)), *tmo,
            int(tmo[0] == tmo[1] == tmo[2] == tmo[3]), st.n_slots - 1,
            st.pref_mask]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(c_ptrs, c_ints, stream)
    if rc != 0:
        raise RuntimeError(f"B3 one-pass launch failed: cudaError {rc}")
    launches += 1
    return outs
