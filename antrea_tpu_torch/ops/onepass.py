"""B3, the one-pass slow path: for every lane of a batch, the flow-cache
probe decode; for its miss lanes the interval searches on the post-DNAT
tuple, the isolation bits and the aggregate rows read from the tables, the
aggregate AND with its zero-AND skip and fallback flag, the K lowest
candidate superblocks and their first match per rule phase; then verdict
resolution, the ServiceLB overlay, the cached/fresh image merge, and the
forward and reply commit rows (with the reply slot's flow hash), in one
pass.

Replaces the Pallas kernel antrea_tpu/ops/match.py:_onepass_call in both
its variants, together with the probes that the JAX step runs ahead of it
(antrea_tpu/models/pipeline.py:1684-1711): the single-card resolve variant
(resolve=True), and the rule shard's hits-only variant (resolve=False),
which stops after the per-phase first matches over the shard's words and
emits them as global rule indices (hits8), for the caller to re-walk its
fallback lanes, combine across the rule shards (parallel/mesh.py) and
resolve.  The CUDA kernel is csrc/onepass.cu, one template instantiation
per variant.  It takes the lane columns gathered at batch start and the
rule tables (interval bounds, aggregate and incidence tables, isolation
tables, actions, and the program-to-service map for the toServices probe),
so no (B, S) matrix is built per step.  It is bound by bytes: a lane's 29
input and 44 output words stream once (about 38 MB at B = 2**17, 11.4 us
at the H100's 3.35 TB/s; hits-only: 17 and 20 words, the lb row of a miss
lane and the meta row only under per-state timeouts); a miss lane adds
its searches, its six or seven aggregate rows and up to 6 * K * 128 B of
candidate blocks, which the lanes share through L2.

onepass() is the wrapper: on CPU tensors it runs onepass_plain(), the plain
PyTorch version (torch searchsorted and gathers for the probes, then a
straight transcription of the kernel over all lanes); on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _build
from ..compiler.compile import ACT_ALLOW, ACT_REJECT, SVCREF_BASE, SVCREF_NONE
from . import match
from .consumer import phase_first_from_base
from .pruned_consumer import candidate_mats

# Kernel launches since the counter was last set to 0: launches of the
# resolve variant, launches_hits of the hits-only variant (B3h).  Only the
# CUDA launch in onepass() adds to them.
launches = 0
launches_hits = 0


class OnepassInputs(NamedTuple):
    """The per-lane inputs (int32, u32 words as int32 bits)."""

    pkt: torch.Tensor  # (B, 8) [src_f, dst_f, proto, sport, dport, pp, 0, 0]
    kr: torch.Tensor  # (B, 4) flow-cache key rows gathered at batch start
    ts: torch.Tensor  # (B,) flow-cache ts gathered at batch start
    mrow: torch.Tensor  # (B, 4) flow-cache meta rows gathered at batch start
    msk: torch.Tensor  # (B, 4) [valid, no_commit, fb_force, 0]
    lb: torch.Tensor  # (B, 8) [svc_idx, no_ep, dnat_ip_f, dnat_port, snat, dsr, 0, 0]


class OnepassTables(NamedTuple):
    """The tables the kernel reads, each dimension in the order ingress
    at/peer/svc, egress at/peer/svc (int32, u32 words as int32 bits)."""

    bounds: tuple  # six (n,) ascending v4 interval bounds (DimTable.bounds)
    agg: tuple  # six (rows, S) aggregate tables (DimTable.agg)
    inc: tuple  # six (rows, S * 32) incidence tables (DimTable.inc)
    iso_bounds: tuple  # (iso_in.bounds, iso_out.bounds)
    iso_val: tuple  # (iso_in.val, iso_out.val), 0/1 per interval row
    act_in: torch.Tensor  # (rules,) ingress actions
    act_out: torch.Tensor  # (rules,) egress actions
    # (P,) LB program -> owning service index, for the toServices probe;
    # None where the rule set has no toServices rule.
    prog_svc: Optional[torch.Tensor] = None


def tables_of(drs: match.DeviceRuleSet,
              prog_svc: Optional[torch.Tensor] = None) -> OnepassTables:
    """B3's tables of a pruned rule set (and, with svcref, the service
    tables' prog_svc)."""
    dims = [getattr(getattr(drs, d), k) for d in ("ingress", "egress")
            for k in ("at", "peer", "svc")]
    return OnepassTables(
        bounds=tuple(t.bounds for t in dims), agg=tuple(t.agg for t in dims),
        inc=tuple(t.inc for t in dims),
        iso_bounds=(drs.iso_in.bounds, drs.iso_out.bounds),
        iso_val=(drs.iso_in.val, drs.iso_out.val),
        act_in=drs.ingress.action, act_out=drs.egress.action,
        prog_svc=prog_svc)


class OnepassStatic(NamedTuple):
    """Shape constants of a call (plain ints)."""

    k: int  # candidate superblocks per lane and direction (prune budget)
    in_phases: tuple
    out_phases: tuple
    svcref: bool
    timeouts: tuple  # (tcp_syn, tcp_est, other_new, other_est)
    n_slots: int  # flow-cache slots (a power of two)
    pref_mask: int


def lane_probes(tabs: OnepassTables, svcref: bool, miss: torch.Tensor,
                src_f, proto, svc_idx, dnat_ip, dnat_port):
    """The lanes' probes on the post-DNAT tuple, in torch: ingress at with
    dnat_ip, peer with src_f, svc with (proto << 16) | dnat_port; egress at
    with src_f, peer with dnat_ip, svc with the same service key; with
    svcref the toServices key of the lane's program in egress svc.  Lanes
    not in miss take row 0 everywhere.  -> (the six interval rows, the
    svcref row (zero without svcref), the six aggregate rows with the
    svcref row ORed into egress svc, iso_in, iso_out)."""
    src_f, dnat_ip = src_f.contiguous(), dnat_ip.contiguous()
    svc_key = (proto << 16) | dnat_port

    def midx(bounds, key):
        return torch.where(miss, torch.searchsorted(bounds, key, right=True),
                           0)

    rows = [midx(b, k) for b, k in zip(
        tabs.bounds, (dnat_ip, src_f, svc_key, src_f, dnat_ip, svc_key))]
    aggs = [t[r] for t, r in zip(tabs.agg, rows)]
    ref_row = torch.zeros_like(rows[0])
    if svcref:
        n = tabs.prog_svc.shape[0]
        ref = torch.where(svc_idx >= 0,
                          tabs.prog_svc[svc_idx.clamp(0, n - 1).long()], -1)
        ref_key = torch.where(ref >= 0, SVCREF_BASE + ref, SVCREF_NONE)
        ref_row = midx(tabs.bounds[5], ref_key.to(torch.int32))
        aggs[5] = aggs[5] | tabs.agg[5][ref_row]
    iso_in = tabs.iso_val[0][midx(tabs.iso_bounds[0], dnat_ip)]
    iso_out = tabs.iso_val[1][midx(tabs.iso_bounds[1], src_f)]
    return rows, ref_row, aggs, iso_in, iso_out


def probes_plain(x: OnepassInputs, tabs: OnepassTables, svcref: bool,
                 miss: torch.Tensor):
    """lane_probes on B3's lane inputs -> (iv (B, 8) int32 [in_at,
    in_peer, in_svc, out_at, out_peer, out_svc, svcref_row, iso_in |
    iso_out << 1], zero on lanes not in miss; the six aggregate rows;
    iso_in; iso_out)."""
    rows, ref_row, aggs, iso_in, iso_out = lane_probes(
        tabs, svcref, miss, x.pkt[:, 0], x.pkt[:, 2], x.lb[:, 0], x.lb[:, 2],
        x.lb[:, 3])
    iso = torch.where(miss, iso_in | (iso_out << 1), 0)
    iv = torch.stack([c.to(torch.int32) for c in (*rows, ref_row, iso)],
                     dim=1)
    return iv, aggs, iso_in, iso_out


def onepass_plain(x: OnepassInputs, tabs: OnepassTables, now: int,
                  gen_w: int, st: OnepassStatic, w0_in: int = 0,
                  w0_out: int = 0, resolve: bool = True):
    """Plain PyTorch version of the kernel.  resolve -> (main (B, 16),
    keys8 (B, 8), meta8 (B, 8), aux (B, 4), iv (B, 8)) int32; the first four
    are the columns of match.py:2136-2152: main [code, rule_in, rule_out,
    svc, dnat_ip_f, dnat_port, snat, dsr, committed, rev_ins, rev_slot, hit,
    est, rpl, ins, 0]; aux [skip, fb, cand, 0]; iv is probes_plain's.
    Hits-only (resolve=False) -> (hits8 (B, 8) [in0, ink, inb, out0, outk,
    outb, 0, 0], aux, iv), the hits global rule indices (w0_in, w0_out
    added), BIG where a phase has no match."""
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
    tmo = st.timeouts
    if tmo[0] == tmo[1] == tmo[2] == tmo[3]:
        timeout = tmo[1]
    else:
        timeout = pl.entry_timeout((mr[:, 3] >> 29) & 1, proto, tmo)
    hit = key_hit & ((now - x.ts) <= timeout) & valid
    est = hit & ((kpg == pg_est) | (kpg == pg_rpl))
    rpl = hit & (kpg == pg_rpl)
    miss = ~hit & valid
    iv, aggs, iso_in, iso_out = probes_plain(x, tabs, st.svcref, miss)

    # Per direction: aggregate AND (non-miss lanes spawn no candidates),
    # the ke lowest candidate superblocks, their words, the first match.
    hits, ncs, kes = [], [], []
    for d, phases, w0 in ((0, st.in_phases, w0_in), (1, st.out_phases, w0_out)):
        a, p, s = aggs[3 * d:3 * d + 3]
        ke = min(st.k, a.shape[1])
        g = torch.where(miss[:, None], a & p & s, 0)
        ca, cp, cs, base = candidate_mats(
            tabs.inc[3 * d:3 * d + 3], g, iv[:, 3 * d:3 * d + 3].unbind(1),
            iv[:, 6] if st.svcref and d == 1 else None, ke, w0)
        hits += phase_first_from_base(ca & cp & cs, base, phases)
        ncs.append((g != 0).sum(dim=1, dtype=torch.int32))
        kes.append(ke)
    skip = miss & (ncs[0] == 0) & (ncs[1] == 0)
    fb = miss & ((ncs[0] > kes[0]) | (ncs[1] > kes[1]) | fb_force)
    cand = torch.maximum(ncs[0], ncs[1])
    i32 = torch.int32
    aux = torch.stack([skip.to(i32), fb.to(i32), cand,
                       torch.zeros_like(cand)], dim=1)
    if not resolve:
        z = torch.zeros_like(cand)
        return torch.stack([*hits, z, z], dim=1).to(i32), aux, iv

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
    main = torch.stack([
        merge(c_code, f_code, ACT_ALLOW), merge(c_ri, f_ri, pl.MISS),
        merge(c_ro, f_ro, pl.MISS), merge(c_svc, svc_idx, pl.MISS),
        merge(mr[:, 0], dnat_ip, dst_f), merge(c_dport, dnat_port, dport),
        merge((mr[:, 3] >> 31) & 1, snat_m, 0, fwd_hit),
        merge((mr[:, 3] >> 30) & 1, dsr_m, 0, fwd_hit),
        rows["committed"].to(i32), rows["rev_ins"].to(i32), rows["rev_slot"],
        hit.to(i32), est.to(i32), rpl.to(i32), rows["ins"].to(i32),
        torch.zeros_like(src_f)], dim=1).to(i32)
    return main, rows["keys8"], rows["meta8"], aux, iv


def _check(x: OnepassInputs, tabs: OnepassTables,
           svcref: bool) -> tuple[int, int, int]:
    """Dtype, device, shape and contiguity checks -> (B, S_in, S_out)."""
    if not (len(tabs.bounds) == len(tabs.agg) == len(tabs.inc) == 6
            and len(tabs.iso_bounds) == len(tabs.iso_val) == 2):
        raise ValueError("B3 takes six dimension tables and two isolation "
                         "tables")
    b = x.pkt.shape[0]
    dev = x.pkt.device
    s_in, s_out = tabs.agg[0].shape[-1], tabs.agg[3].shape[-1]
    want = [("pkt", x.pkt, (b, 8)), ("kr", x.kr, (b, 4)), ("ts", x.ts, (b,)),
            ("mrow", x.mrow, (b, 4)), ("msk", x.msk, (b, 4)),
            ("lb", x.lb, (b, 8))]
    for i, (bd, a, t) in enumerate(zip(tabs.bounds, tabs.agg, tabs.inc)):
        s = s_in if i < 3 else s_out
        rows = a.shape[0]
        want += [(f"bounds[{i}]", bd, (bd.shape[0],)),
                 (f"agg[{i}]", a, (rows, s)), (f"inc[{i}]", t, (rows, 32 * s))]
        if rows < bd.shape[0] + 1:
            raise ValueError(f"B3 table {i} needs a row per interval: "
                             f"{rows} rows for {bd.shape[0]} bounds")
    for i, (bd, v) in enumerate(zip(tabs.iso_bounds, tabs.iso_val)):
        want += [(f"iso_bounds[{i}]", bd, (bd.shape[0],)),
                 (f"iso_val[{i}]", v, (v.shape[0],))]
        if v.shape[0] < bd.shape[0] + 1:
            raise ValueError(f"B3 isolation table {i} needs a value per "
                             f"interval")
    want += [("act_in", tabs.act_in, (tabs.act_in.shape[0],)),
             ("act_out", tabs.act_out, (tabs.act_out.shape[0],))]
    if svcref:
        if tabs.prog_svc is None or tabs.prog_svc.shape[0] < 1:
            raise ValueError("B3 with svcref needs prog_svc")
        want.append(("prog_svc", tabs.prog_svc, (tabs.prog_svc.shape[0],)))
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
            st: OnepassStatic, w0_in: int = 0, w0_out: int = 0,
            resolve: bool = True):
    """resolve -> (main (B, 16), keys8 (B, 8), meta8 (B, 8), aux (B, 4),
    iv (B, 8)); hits-only (resolve=False) -> (hits8 (B, 8), aux (B, 4),
    iv (B, 8)); int32, see onepass_plain.  w0_in / w0_out: the tables' first
    global word (a rule shard's offset).  CPU tensors: the plain version.
    CUDA tensors: the B3 kernel."""
    global launches, launches_hits
    b, s_in, s_out = _check(x, tabs, st.svcref)
    dev = x.pkt.device
    if dev.type == "cpu":
        return onepass_plain(x, tabs, now, gen_w, st, w0_in, w0_out, resolve)
    if dev.type != "cuda":
        raise ValueError(f"onepass runs on cpu or cuda tensors, not {dev}")
    outs = tuple(torch.empty((b, n), dtype=torch.int32, device=dev)
                 for n in ((16, 8, 8, 4, 8) if resolve else (8, 4, 8)))
    if b == 0:
        return outs
    if st.k < 1 or st.n_slots & (st.n_slots - 1):
        raise ValueError("B3 needs k >= 1 and a power-of-two slot count")
    # The kernel reads the lane rows 16 bytes at a time.
    for t in (x.pkt, x.kr, x.mrow, x.msk, x.lb):
        if t.data_ptr() % 16:
            raise ValueError("B3 lane inputs must be 16-byte aligned")
    svcref = bool(st.svcref)
    prog_svc = tabs.prog_svc if svcref else tabs.act_in  # unread when off
    tmo = st.timeouts
    ptrs = [t.data_ptr() for t in (
        x.pkt, x.kr, x.ts, x.mrow, x.msk, x.lb, *tabs.bounds,
        *tabs.iso_bounds, *tabs.agg, *tabs.inc, *tabs.iso_val, prog_svc,
        tabs.act_in, tabs.act_out)]
    # main (hits8), keys8, meta8 (none for hits-only), aux, iv.
    ptrs += ([t.data_ptr() for t in outs] if resolve else
             [outs[0].data_ptr(), None, None, outs[1].data_ptr(),
              outs[2].data_ptr()])
    ints = [b, s_in, s_out, min(st.k, s_in), min(st.k, s_out),
            tabs.act_in.shape[0], tabs.act_out.shape[0], prog_svc.shape[0],
            int(now), int(gen_w), int(w0_in), int(w0_out), st.in_phases[0],
            st.in_phases[1], st.out_phases[0], st.out_phases[1], int(svcref),
            *tmo, int(tmo[0] == tmo[1] == tmo[2] == tmo[3]), st.n_slots - 1,
            st.pref_mask, *(t.shape[0] for t in tabs.bounds),
            *(t.shape[0] for t in tabs.iso_bounds), int(resolve)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(c_ptrs, c_ints, stream)
    if rc != 0:
        raise RuntimeError(f"B3 one-pass launch failed: cudaError {rc}")
    with _build.LOCK:
        if resolve:
            launches += 1
        else:
            launches_hits += 1
    return outs
