"""The full per-packet walk: SpoofGuard / ARP -> (IGMP punt) -> the policy
and service pipeline -> L2/L3 forwarding -> Output.  The PyTorch port of
antrea_tpu/models/forwarding.py, v4 and v6 lanes (a dual-stack pipeline's
v6 lanes spoof-guard, forward and take their TrafficControl mark through
the lexicographic v6 sub-tables, and answer Neighbor Discovery).

The forwarding tables (compiler/topology.py) are sorted tensors: a packet's
output decision is a few searchsorted probes and row gathers, run as plain
tensor ops beside the pipeline step (models/pipeline.py), whose slow path
holds the kernels.

SpoofGuard sits before conntrack and the policy tables, so a spoofed packet
neither refreshes nor commits conntrack state: its mask is passed to the
step as the `valid` lane mask, which keeps those lanes out of the cache
refresh, the slow path and the commit.  Multicast destinations and FIN/RST
TCP misses classify but commit nothing (the step's `no_commit` mask).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..compiler.compile import ACT_ALLOW, ACT_DROP
from ..compiler.topology import (
    ARP_OP_REQUEST,
    FIRST_POD_OFPORT,
    FWD_ARP_FLOOD,
    FWD_ARP_REPLY,
    FWD_DROP_MCAST,
    FWD_DROP_SPOOF,
    FWD_DROP_UNKNOWN,
    FWD_GATEWAY,
    FWD_LOCAL,
    FWD_MCAST,
    FWD_PUNT,
    FWD_TUNNEL,
    MCAST_HI_F,
    MCAST_LO_F,
    OFPORT_GATEWAY,
    OFPORT_REPLICATE,
    OFPORT_TUNNEL,
    PROTO_IGMP,
    TC_REDIRECT,
    ForwardingTables,
)
from ..ops.match import from_numpy, resolve_device
from . import pipeline as pl

_I32 = torch.int32


class DeviceForwardingTables(NamedTuple):
    lp_ip_f: torch.Tensor
    lp_port: torch.Tensor
    lp_tc_in: torch.Tensor
    lp_tc_eg: torch.Tensor
    n_lp: torch.Tensor
    rn_lo_f: torch.Tensor
    rn_hi_f: torch.Tensor
    rn_peer_f: torch.Tensor
    n_rn: torch.Tensor
    local_range_f: torch.Tensor
    mc_ip_f: torch.Tensor
    n_mc: torch.Tensor
    arp_ip_f: torch.Tensor
    n_arp: torch.Tensor
    # The v6 sub-tables: per-word flipped 4-word rows, n_* valid rows each.
    lp6_ipw: torch.Tensor
    lp6_port: torch.Tensor
    lp6_tc_in: torch.Tensor
    lp6_tc_eg: torch.Tensor
    n_lp6: torch.Tensor
    rn6_lo_w: torch.Tensor
    rn6_hi_w: torch.Tensor
    rn6_peer_w: torch.Tensor
    n_rn6: torch.Tensor
    local_range6_w: torch.Tensor
    nd_ipw: torch.Tensor
    n_nd: torch.Tensor


def fwd_to_device(ft: ForwardingTables, device=None) -> DeviceForwardingTables:
    """Numpy forwarding tables (compile_topology's, or the JAX package's
    after device_get) -> tensors on `device` (None: the card)."""
    return from_numpy(DeviceForwardingTables, ft, resolve_device(device))


def _lex_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a <= b over the trailing 4-word axis (per-word
    sign-flipped int32, so signed compares give unsigned order)."""
    lt = a < b
    eq = a == b
    return lt[..., 0] | (eq[..., 0] & (lt[..., 1] | (eq[..., 1] & (
        lt[..., 2] | (eq[..., 2] & (lt[..., 3] | eq[..., 3]))))))


def _lp_row(dft: DeviceForwardingTables, ip_f: torch.Tensor):
    """-> (row, known) local-pod probe by flipped IP."""
    cap = dft.lp_ip_f.shape[0]
    row = torch.searchsorted(dft.lp_ip_f, ip_f).clamp(0, cap - 1)
    known = (row < dft.n_lp[0]) & (dft.lp_ip_f[row] == ip_f)
    return row, known


def _row_eq_wide(table: torch.Tensor, n: torch.Tensor, xw: torch.Tensor):
    """-> (row, known) exact 4-word row match over one node's small v6
    tables (its pods, its ND addresses): all pairs, as in the JAX
    package."""
    cap = table.shape[0]
    eq = (table[None, :, :] == xw[:, None, :]).all(dim=2)  # (B, cap)
    eq = eq & (torch.arange(cap, device=xw.device) < n[0])[None, :]
    known = eq.any(dim=1)
    # torch has no bool argmax; both frameworks return the first maximum.
    row = eq.to(_I32).argmax(dim=1).to(_I32)
    return row, known


def spoof_lookup(dft: DeviceForwardingTables, src_f: torch.Tensor,
                 in_port: torch.Tensor, src_w=None, is6=None):
    """SpoofGuard: packets entering on a pod ofport must source an IP bound
    to that port (v6 lanes resolve in the lexicographic sub-table)."""
    row, known = _lp_row(dft, src_f)
    pod_in = in_port >= FIRST_POD_OFPORT
    spoof4 = pod_in & (~known | (dft.lp_port[row] != in_port))
    if src_w is None:
        return spoof4
    row6, known6 = _row_eq_wide(dft.lp6_ipw, dft.n_lp6, src_w)
    spoof6 = pod_in & (~known6 | (dft.lp6_port[row6] != in_port))
    return torch.where(is6 != 0, spoof6, spoof4)


def forwarding_lookup(dft: DeviceForwardingTables, dst_f: torch.Tensor,
                      in_port: torch.Tensor) -> dict:
    """L2ForwardingCalc + L3Forwarding + L3DecTTL -> dict(kind, out_port,
    peer_f, dec_ttl, lp_row, is_local, is_mc, mcast_idx)."""
    row, is_local = _lp_row(dft, dst_f)
    rcap = dft.rn_lo_f.shape[0]
    r = torch.searchsorted(dft.rn_hi_f, dst_f).clamp(0, rcap - 1)
    in_rn = ((r < dft.n_rn[0]) & (dft.rn_lo_f[r] <= dst_f)
             & (dst_f <= dft.rn_hi_f[r]))
    in_local_cidr = ((dft.local_range_f[0] <= dst_f)
                     & (dst_f <= dft.local_range_f[1]))
    # Multicast: a 224.0.0.0/4 dst resolves against the joined-group table
    # (a hit replicates, a miss drops), ahead of the unicast branches.
    is_mc = (dst_f >= MCAST_LO_F) & (dst_f <= MCAST_HI_F)
    mcap = dft.mc_ip_f.shape[0]
    mrow = torch.searchsorted(dft.mc_ip_f, dst_f).clamp(0, mcap - 1)
    mc_hit = is_mc & (mrow < dft.n_mc[0]) & (dft.mc_ip_f[mrow] == dst_f)
    mcast_idx = torch.where(mc_hit, mrow, -1).to(_I32)

    kind = torch.where(
        is_mc, torch.where(mc_hit, FWD_MCAST, FWD_DROP_MCAST),
        torch.where(is_local, FWD_LOCAL, torch.where(
            in_rn, FWD_TUNNEL,
            torch.where(in_local_cidr, FWD_DROP_UNKNOWN, FWD_GATEWAY)),
        )).to(_I32)
    out_port = torch.where(
        is_mc, torch.where(mc_hit, OFPORT_REPLICATE, -1),
        torch.where(is_local, dft.lp_port[row], torch.where(
            in_rn, OFPORT_TUNNEL,
            torch.where(in_local_cidr, -1, OFPORT_GATEWAY))),
    ).to(_I32)
    peer_f = torch.where(in_rn & ~is_local & ~is_mc, dft.rn_peer_f[r], 0)
    # L3DecTTL: every routed leg (egress via tunnel or gateway, or local
    # delivery of traffic that arrived routed); multicast does not.
    routed_in = (in_port == OFPORT_TUNNEL) | (in_port == OFPORT_GATEWAY)
    dec_ttl = torch.where(
        is_mc, 0,
        torch.where(is_local, routed_in.to(_I32),
                    (in_rn | (kind == FWD_GATEWAY)).to(_I32))).to(_I32)
    return {"kind": kind, "out_port": out_port, "peer_f": peer_f.to(_I32),
            "dec_ttl": dec_ttl, "lp_row": row, "is_local": is_local,
            "is_mc": is_mc, "mcast_idx": mcast_idx}


def forwarding_lookup6(dft: DeviceForwardingTables, dst_w: torch.Tensor,
                       in_port: torch.Tensor) -> dict:
    """The v6 leg of L2ForwardingCalc + L3Forwarding + L3DecTTL
    (forwarding.py:207): an exact local-pod match, the inclusive [lo, hi]
    word interval of a remote node's v6 podCIDR (a few dozen rows, all
    pairs), the local-CIDR unknown-pod drop, the gateway default; no v6
    multicast.  -> forwarding_lookup's dict with peer_w ((B, 4)) in place
    of peer_f."""
    row, is_local = _row_eq_wide(dft.lp6_ipw, dft.n_lp6, dst_w)
    rcap = dft.rn6_lo_w.shape[0]
    in_row = (_lex_le(dft.rn6_lo_w[None, :, :], dst_w[:, None, :])
              & _lex_le(dst_w[:, None, :], dft.rn6_hi_w[None, :, :])
              & (torch.arange(rcap, device=dst_w.device)
                 < dft.n_rn6[0])[None, :])
    in_rn = in_row.any(dim=1)
    r = in_row.to(_I32).argmax(dim=1)
    in_local_cidr = (_lex_le(dft.local_range6_w[0][None, :], dst_w)
                     & _lex_le(dst_w, dft.local_range6_w[1][None, :]))
    kind = torch.where(is_local, FWD_LOCAL, torch.where(
        in_rn, FWD_TUNNEL,
        torch.where(in_local_cidr, FWD_DROP_UNKNOWN, FWD_GATEWAY))).to(_I32)
    out_port = torch.where(is_local, dft.lp6_port[row], torch.where(
        in_rn, OFPORT_TUNNEL,
        torch.where(in_local_cidr, -1, OFPORT_GATEWAY))).to(_I32)
    peer_w = torch.where((in_rn & ~is_local)[:, None], dft.rn6_peer_w[r], 0)
    routed_in = (in_port == OFPORT_TUNNEL) | (in_port == OFPORT_GATEWAY)
    dec_ttl = torch.where(is_local, routed_in,
                          in_rn | (kind == FWD_GATEWAY)).to(_I32)
    return {"kind": kind, "out_port": out_port, "peer_w": peer_w.to(_I32),
            "dec_ttl": dec_ttl, "lp_row": row, "is_local": is_local}


def tc_lookup(dft: DeviceForwardingTables, src_f: torch.Tensor,
              dst_row: torch.Tensor, dst_is_local: torch.Tensor):
    """TrafficControl mark: the dst pod's ingress word wins, else the src
    pod's egress word.  -> packed word."""
    srow, sknown = _lp_row(dft, src_f)
    w_in = torch.where(dst_is_local, dft.lp_tc_in[dst_row], 0)
    w_eg = torch.where(sknown, dft.lp_tc_eg[srow], 0)
    return torch.where(w_in != 0, w_in, w_eg)


def tc_lookup6(dft: DeviceForwardingTables, src_w: torch.Tensor,
               dst_row6: torch.Tensor, dst_is_local6: torch.Tensor):
    """tc_lookup's v6 leg over the lexicographic pod table."""
    srow, sknown = _row_eq_wide(dft.lp6_ipw, dft.n_lp6, src_w)
    w_in = torch.where(dst_is_local6, dft.lp6_tc_in[dst_row6], 0)
    w_eg = torch.where(sknown, dft.lp6_tc_eg[srow], 0)
    return torch.where(w_in != 0, w_in, w_eg)


def pipeline_step_full(
    state: pl.PipelineState,
    drs,
    dsvc,
    dft: DeviceForwardingTables,
    src_f: torch.Tensor,
    dst_f: torch.Tensor,
    proto: torch.Tensor,
    sport: torch.Tensor,
    dport: torch.Tensor,
    in_port: torch.Tensor,
    now: int,
    gen: int,
    flags: torch.Tensor = None,
    arp_op: torch.Tensor = None,
    lens: torch.Tensor = None,
    *,
    meta: pl.PipelineMeta,
    hit_combine=None,
    v6=None,
    valid=None,
    no_commit=None,
    prune_exclude=None,
):
    """The full per-packet walk (forwarding.py:289-494): SpoofGuard / ARP ->
    (IGMP punt) -> models/pipeline.pipeline_step -> forwarding -> Output.
    -> (state, out): the step's outputs with code, reject_kind, spoofed,
    l7_redirect, punt, fwd_kind, out_port, peer_f, dec_ttl, tc_act, tc_port
    and mcast_idx; state is updated in place.

    valid / no_commit are optional external lane masks ANDed / ORed into the
    ones derived here (spoof, ARP and IGMP lanes excluded; multicast and
    FIN/RST TCP lanes commit nothing).  hit_combine is the rule-axis seam
    (parallel/mesh.py).  arp_op lanes (0 = not ARP) touch no conntrack or
    policy state: answered requests for addresses this node owns reply out
    the ingress port, every other ARP lane floods.  lens are the lanes'
    byte lengths for the flow counters (meta.count_flow_stats).

    v6 = (src6w_f, dst6w_f, is6), the v6 lanes of a dual-stack pipeline:
    they spoof-guard, forward (by their wide effective destination) and
    take their TC mark through the v6 sub-tables, an arp_op on a v6 lane is
    Neighbor Discovery (a request answers from the nd table), and the walk
    adds peer_w, the wide tunnel peer.  prune_exclude ((B,) bool) marks the
    lanes whose prune evidence and probe counters another dispatch owns
    (the mesh engine's spill, parallel/meshpath.py)."""
    m6 = is6 = saddr_w = daddr_w = None
    if v6 is not None:
        src6w, dst6w, is6 = v6
        saddr_w = pl._wide_words(src_f, src6w, is6)
        daddr_w = pl._wide_words(dst_f, dst6w, is6)
        m6 = is6 != 0
        spoof = spoof_lookup(dft, src_f, in_port, src_w=saddr_w, is6=is6)
    else:
        spoof = spoof_lookup(dft, src_f, in_port)
    # IGMP membership traffic is punted to the controller, never forwarded:
    # kept out of the policy pipeline like spoofed lanes.
    is_arp = (arp_op > 0) if arp_op is not None else None
    igmp = ~spoof & (proto == PROTO_IGMP)
    if is_arp is not None:
        igmp = igmp & ~is_arp
    # Multicast data traffic bypasses conntrack: classified every step,
    # never cached.  The 224/4 window is v4: a v6 lane's narrow dst is a
    # don't-care.
    is_mc = (dst_f >= MCAST_LO_F) & (dst_f <= MCAST_HI_F)
    if m6 is not None:
        is_mc = is_mc & ~m6
    no_commit_l = is_mc
    if flags is not None:
        # A FIN/RST TCP miss classifies but never establishes a connection.
        no_commit_l = no_commit_l | ((proto == pl.PROTO_TCP)
                                     & ((flags & pl._TEARDOWN_FLAGS) != 0))
    if no_commit is not None:
        no_commit_l = no_commit_l | (no_commit != 0)
    valid_l = ~spoof & ~igmp
    if is_arp is not None:
        valid_l = valid_l & ~is_arp
    if valid is not None:
        valid_l = valid_l & (valid != 0)
    state, out = pl.pipeline_step(
        state, drs, dsvc, src_f, dst_f, proto, sport, dport, now, gen,
        meta=meta, flags=flags, hit_combine=hit_combine, valid=valid_l,
        no_commit=no_commit_l, lens=lens, v6=v6, prune_exclude=prune_exclude)
    code = torch.where(spoof, ACT_DROP, out["code"]).to(_I32)
    # Forward toward the DNAT-resolved endpoint, except reply-direction
    # hits (their dnat fields carry the source un-rewrite): a reply
    # forwards to its literal dst.
    eff_dst = torch.where(out["reply"] == 1, dst_f, out["dnat_ip_f"])
    fwd = forwarding_lookup(dft, eff_dst, in_port)
    peer_w = None
    if m6 is not None:
        # v6 lanes forward by their wide effective destination; the two
        # families' results merge per lane.
        eff_dst_w = torch.where((out["reply"] == 1)[:, None], daddr_w,
                                out["dnat_w_f"])
        fwd6 = forwarding_lookup6(dft, eff_dst_w, in_port)
        fwd = {
            "kind": torch.where(m6, fwd6["kind"], fwd["kind"]),
            "out_port": torch.where(m6, fwd6["out_port"], fwd["out_port"]),
            "peer_f": torch.where(m6, 0, fwd["peer_f"]),
            "dec_ttl": torch.where(m6, fwd6["dec_ttl"], fwd["dec_ttl"]),
            "lp_row": fwd["lp_row"],
            "is_local": torch.where(m6, fwd6["is_local"], fwd["is_local"]),
            "is_mc": fwd["is_mc"] & ~m6,
            "mcast_idx": torch.where(m6, -1, fwd["mcast_idx"]),
            "lp_row6": fwd6["lp_row"],
            "is_local6": fwd6["is_local"] & m6,
        }
        # The wide peer view: v4 tunnel peers in mapped form, v6 native.
        peer_w = torch.where(m6[:, None], fwd6["peer_w"],
                             pl._wide_words(fwd["peer_f"], None, None))
    kind = torch.where(spoof, FWD_DROP_SPOOF,
                       torch.where(igmp, FWD_PUNT, fwd["kind"])).to(_I32)
    if is_arp is not None:
        # ARPResponder: answered requests reply out the ingress port;
        # unanswered (or reply-opcode) ARP floods.
        acap = dft.arp_ip_f.shape[0]
        arow = torch.searchsorted(dft.arp_ip_f, dst_f).clamp(0, acap - 1)
        answer = (is_arp & ~spoof & (arow < dft.n_arp[0])
                  & (dft.arp_ip_f[arow] == dst_f)
                  & (arp_op == ARP_OP_REQUEST))
        if m6 is not None:
            # Neighbor Discovery: a v6 request answers from the nd table.
            _ndrow, nd_known = _row_eq_wide(dft.nd_ipw, dft.n_nd, daddr_w)
            answer = torch.where(
                m6, is_arp & ~spoof & nd_known & (arp_op == ARP_OP_REQUEST),
                answer)
        kind = torch.where(is_arp & ~spoof,
                           torch.where(answer, FWD_ARP_REPLY, FWD_ARP_FLOOD),
                           kind).to(_I32)
    deliverable = (code == ACT_ALLOW) & (
        (kind == FWD_LOCAL) | (kind == FWD_TUNNEL) | (kind == FWD_GATEWAY)
        | (kind == FWD_MCAST))
    uni_deliverable = deliverable & (kind != FWD_MCAST)
    tc_base = tc_lookup(dft, src_f, fwd["lp_row"], fwd["is_local"])
    if m6 is not None:
        tc_base = torch.where(
            m6, tc_lookup6(dft, saddr_w, fwd["lp_row6"], fwd["is_local6"]),
            tc_base)
    tc_w = torch.where(uni_deliverable, tc_base, 0)
    tc_act = tc_w & 3
    tc_port = tc_w >> 2
    out_port = torch.where(deliverable, fwd["out_port"], -1)
    if is_arp is not None:
        out_port = torch.where(kind == FWD_ARP_REPLY, in_port, out_port)
    # Redirect replaces the output port.
    out_port = torch.where(tc_act == TC_REDIRECT, tc_port, out_port)

    # L7 redirect mark: set when the deciding allow rule carries L7
    # protocols, by attribution index against the current rule table.
    def l7_of(dd, idx):
        n = dd.l7.shape[0]
        safe = idx.clamp(0, n - 1).long()
        return torch.where((idx >= 0) & (idx < n), dd.l7[safe], 0)

    l7 = torch.where(code == ACT_ALLOW,
                     l7_of(drs.ingress, out["ingress_rule"])
                     | l7_of(drs.egress, out["egress_rule"]), 0).to(_I32)
    out.update(
        code=code,
        reject_kind=pl.reject_kind_of(code, proto),
        spoofed=spoof.to(_I32),
        l7_redirect=l7,
        punt=igmp.to(_I32),
        fwd_kind=kind,
        out_port=out_port.to(_I32),
        peer_f=torch.where(uni_deliverable, fwd["peer_f"], 0).to(_I32),
        dec_ttl=torch.where(uni_deliverable, fwd["dec_ttl"], 0).to(_I32),
        tc_act=tc_act.to(_I32),
        tc_port=tc_port.to(_I32),
        mcast_idx=torch.where(deliverable, fwd["mcast_idx"], -1).to(_I32),
    )
    if peer_w is not None:
        # Zeroed like peer_f for lanes not delivered by unicast.
        out["peer_w"] = torch.where(uni_deliverable[:, None], peer_w,
                                    0).to(_I32)
    return state, out

