"""The engine's step, replayed from an empty state.

A direct-mapped flow cache of `flow_slots` rows: a lane hits when its slot
holds its own 5-tuple (a forward entry, or a committed connection's reply
entry).  A hit returns what the entry cached: verdict, rules, Service and
DNAT (a reply entry: the original frontend), est for a committed (allowed)
connection, reply for a reply entry.  A miss is load-balanced, classified
on its post-DNAT tuple and written back: the forward entry always (denials
too), and for an allowed flow the reply entry keyed on (endpoint, client,
endpoint port, client port); multicast destinations are classified every
time and never cached.  All lanes of a batch look up the state before it;
writes to one slot resolve to the last lane in batch order, a lane's
forward entry before its reply entry.

An entry lives while `now` - its last use <= the conntrack timeout: a hit
uses it, and an established hit whose partner stamp is half a timeout old
also refreshes its connection's other entry (found by the tuple its
cached DNAT gives, verified by key).  control="slot_hit" is the control of the check:
the same replay with the cache's tuple compare left out (a lane hits
whatever entry holds its slot), which breaks the guarantee that a packet
never takes another flow's cached verdict."""

from __future__ import annotations

import numpy as np
import torch

from . import forwarding as fw
from .forwarding import Forwarding
from .hashing import flow_hash
from .policy import ALLOW, DROP, REJECT, Classifier
from .services import ServiceLB

FIELDS = ("code", "reject_kind", "ingress_rule", "egress_rule", "svc_idx",
          "dnat_ip", "dnat_port", "est", "reply", "committed", "fwd_kind",
          "out_port", "peer_ip")


# Engine options the replay models, and those that change how the engine
# works but not what it answers; any other option fails the replay.
MODELLED = ("flow_slots", "aff_slots", "ct_timeout_s")
NEUTRAL = ("fused", "prune_budget", "miss_chunk", "canary_probes")


class Replay:
    def __init__(self, plain: dict, device, control: str | None = None):
        eng = plain["engine"]
        other = sorted(set(eng) - set(MODELLED) - set(NEUTRAL))
        if other:
            raise NotImplementedError(f"engine options {other}: the "
                                      "reference does not model them")
        self.device = torch.device(device)
        self.slots = int(eng["flow_slots"])
        self.aff_slots = int(eng["aff_slots"])
        self.timeout = int(eng["ct_timeout_s"])
        if control not in (None, "slot_hit"):
            raise ValueError(f"unknown control {control!r}")
        self.control = control
        self.cls = Classifier(plain["policy"], self.device)
        self.lb = ServiceLB(plain["services"], self.device)
        self.fwd = Forwarding(plain["topology"], self.device)
        n, a = self.slots + 1, self.aff_slots + 1

        def z(m, dtype=torch.long):
            return torch.zeros(m, dtype=dtype, device=self.device)

        self.occ, self.rpl, self.eternal = z(n, torch.bool), z(n, torch.bool), \
            z(n, torch.bool)
        self.k = z((n, 4))            # src, dst, sport << 16 | dport, proto
        self.v = z((n, 6))            # code, svc, dnat ip, dnat port, rules
        self.ts, self.pref = z(n), z(n)   # last use, partner refresh stamp
        self.aff = [z(a), z(a), z(a), z(a)]  # client, svc, ep + 1, ts

    def _last(self, slots: torch.Tensor, n: int) -> torch.Tensor:
        """Writers to each slot, in order -> mask of the last writer of
        each (masked writers target the dump row n - 1)."""
        order = torch.arange(slots.shape[0], device=slots.device)
        best = torch.full((n,), -1, dtype=torch.long, device=slots.device)
        best.scatter_reduce_(0, slots, order, reduce="amax")
        return best[slots] == order

    def lanes(self, cols: dict) -> dict:
        """Numpy columns (src_ip, dst_ip, proto, src_port, dst_port,
        in_port) -> int64 tensors on the replay's device (addresses as u32
        values)."""
        out = {}
        for k, v in cols.items():
            v = np.asarray(v).astype(np.int64)
            out[k] = torch.from_numpy(v & 0xFFFFFFFF if k.endswith("ip")
                                      else v).to(self.device)
        return out

    def step(self, cols: dict, now: int, outputs: bool = True) -> dict:
        """One batch (self.lanes' tensors) at `now` -> n_miss and, with
        outputs, the numpy outputs (FIELDS, rules as rule numbers into
        self.cls.ids, -1 for none)."""
        src, dst = cols["src_ip"], cols["dst_ip"]
        proto, sport, dport = cols["proto"], cols["src_port"], cols["dst_port"]
        in_port = cols["in_port"]
        S, A = self.slots, self.aff_slots

        known, port = self.fwd.local_pod(src)
        spoof = (in_port >= fw.FIRST_POD_OFPORT) & (~known | (port != in_port))
        igmp = ~spoof & (proto == 2)
        valid = ~spoof & ~igmp
        nc = (dst >= fw.MC_LO) & (dst <= fw.MC_HI)

        h = flow_hash(src, dst, proto, sport, dport)
        slot = h & (S - 1)
        key = torch.stack([src, dst, (sport << 16) | dport, proto], dim=1)
        hit = valid & self.occ[slot] & (now - self.ts[slot] <= self.timeout)
        if self.control != "slot_hit":
            hit &= (self.k[slot] == key).all(dim=1)
        miss = valid & ~hit
        e = self.v[slot]
        reply = hit & self.rpl[slot]
        est = hit & self.eternal[slot]
        # Refresh: the hit entries, and the partners of established hits
        # whose stamp is half a timeout old.
        need = est & (now - self.pref[slot] >= max(1, self.timeout // 2))
        p_src = torch.where(reply, dst, e[:, 2])
        p_dst = torch.where(reply, e[:, 2], src)
        p_sp = torch.where(reply, dport, e[:, 3])
        p_dp = torch.where(reply, e[:, 3], sport)
        p_slot = flow_hash(p_src, p_dst, proto, p_sp, p_dp) & (S - 1)
        p_key = torch.stack([p_src, p_dst, (p_sp << 16) | p_dp, proto], dim=1)
        live = (need & self.occ[p_slot] & self.eternal[p_slot]
                & (self.rpl[p_slot] == ~reply)
                & (self.k[p_slot] == p_key).all(dim=1))
        self.ts[torch.where(hit, slot, S)] = now
        self.ts[torch.where(live, p_slot, S)] = now
        self.pref[torch.where(need, slot, S)] = now

        lb = self.lb.resolve(src, dst, proto, dport, h, self.aff, A, now)
        m_code = torch.where(lb["no_ep"], REJECT, ALLOW)
        m_rin = torch.full_like(src, -1)
        m_rout = torch.full_like(src, -1)
        cl = torch.nonzero(miss & ~lb["no_ep"]).flatten()
        if cl.numel():
            c, ri, ro = self.cls.classify(src[cl], lb["dnat_ip"][cl],
                                          proto[cl], lb["dnat_port"][cl])
            m_code[cl], m_rin[cl], m_rout[cl] = c, ri, ro

        # Commit, every lane's forward then reply entry in batch order;
        # lanes that write nothing target the dump row S.
        committed = miss & (m_code == ALLOW) & ~nc
        ins = miss & ~nc
        rev_slot = flow_hash(lb["dnat_ip"], src, proto, lb["dnat_port"],
                             sport) & (S - 1)
        tgt = torch.stack([torch.where(ins, slot, S),
                           torch.where(committed, rev_slot, S)],
                          dim=1).reshape(-1)
        w = torch.where(self._last(tgt, S + 1), tgt, S)
        rkey = torch.stack([lb["dnat_ip"], src, (lb["dnat_port"] << 16)
                            | sport, proto], dim=1)
        vals = torch.stack([m_code, lb["svc"], lb["dnat_ip"], lb["dnat_port"],
                            m_rin, m_rout], dim=1)
        rvals = torch.stack([m_code, lb["svc"], dst, dport, m_rin, m_rout],
                            dim=1)
        self.k[w] = torch.stack([key, rkey], dim=1).reshape(-1, 4)
        self.v[w] = torch.stack([vals, rvals], dim=1).reshape(-1, 6)
        self.occ[w] = True
        self.ts[w] = now
        self.pref[w] = now
        self.rpl[w] = torch.stack([torch.zeros_like(ins), torch.ones_like(ins)],
                                  dim=1).reshape(-1)
        self.eternal[w] = torch.stack([committed, torch.ones_like(ins)],
                                      dim=1).reshape(-1)
        self.occ[S] = False
        learn = miss & lb["learn"]
        a = torch.where(learn, lb["aslot"], A)
        a = torch.where(self._last(a, A + 1), a, A)
        for tab, val in zip(self.aff, (src, lb["svc"], lb["ep_col"] + 1,
                                       torch.full_like(src, now))):
            tab[a] = val
        self.aff[2][A] = 0

        if not outputs:
            return {"n_miss": int(miss.sum())}
        code = torch.where(hit, e[:, 0], torch.where(miss, m_code, ALLOW))
        code = torch.where(spoof, DROP, code)
        svc = torch.where(hit, e[:, 1], torch.where(miss, lb["svc"], -1))
        dnat_ip = torch.where(hit, e[:, 2], torch.where(miss, lb["dnat_ip"],
                                                        dst))
        dnat_port = torch.where(hit, e[:, 3], torch.where(
            miss, lb["dnat_port"], dport))
        rin = torch.where(hit, e[:, 4], torch.where(miss, m_rin, -1))
        rout = torch.where(hit, e[:, 5], torch.where(miss, m_rout, -1))
        kind, out, peer = self.fwd.lookup(torch.where(reply, dst, dnat_ip))
        kind = torch.where(spoof, fw.DROP_SPOOF,
                           torch.where(igmp, fw.PUNT, kind))
        deliver = (code == ALLOW) & ((kind == fw.LOCAL) | (kind == fw.TUNNEL)
                                     | (kind == fw.GATEWAY)
                                     | (kind == fw.MCAST))
        out = torch.where(deliver, out, -1)
        peer = torch.where((kind == fw.TUNNEL) & (out != -1), peer, 0)
        res = dict(
            code=code, reject_kind=torch.where(
                code == REJECT, torch.where(proto == 6, 1, 2), 0),
            ingress_rule=rin, egress_rule=rout, svc_idx=svc,
            dnat_ip=dnat_ip, dnat_port=dnat_port,
            est=est, reply=reply, committed=committed,
            fwd_kind=kind, out_port=out, peer_ip=peer)
        o = {k: v.long().cpu().numpy() for k, v in res.items()}
        o["n_miss"] = int(miss.sum())
        return o
