"""The policy verdict of a packet, worked out from the policy set itself.

Per direction, in the datapath's stated order: the Antrea-native rules of
the non-baseline tiers by (tier priority, policy priority, rule priority,
policy uid), first match decides and Pass falls through; then, for a pod
isolated by a K8s NetworkPolicy in that direction, the first matching K8s
rule allows and none drops; else the baseline tier's first match (Pass is
no opinion); else allow.  The egress verdict at the source and the ingress
verdict at the destination combine, a denial winning.  A lane tests the
rules that apply to its pod (lanes x those rules at once, in blocks of
lanes), less those an earlier rule of the same phase and condition
shadows."""

from __future__ import annotations

import numpy as np
import torch

from .ip import block_ranges, u32

ALLOW, DROP, REJECT, PASS = 0, 1, 2, 3
_ACT = {"Allow": ALLOW, "Drop": DROP, "Reject": REJECT, "Pass": PASS}
TIER_BASELINE = 253
_PORTFUL = (6, 17, 132)  # TCP, UDP, SCTP: the protocols a port limits
# Lanes classified at once (a block's lanes x candidate rules stay small).
BLOCK = 8192


class _Members:
    """Named address sets over single addresses -> a membership table:
    row = an address (the last row: any address in no set), column = a
    set."""

    def __init__(self, sets: dict, device):
        self.col = {n: i for i, n in enumerate(sets)}
        keys = sorted({u32(ip) for ips in sets.values() for ip in ips})
        self.keys = torch.tensor(keys, dtype=torch.long, device=device)
        tab = torch.zeros((len(keys) + 1, max(1, len(sets))),
                          dtype=torch.bool)
        row = {k: i for i, k in enumerate(keys)}
        for n, ips in sets.items():
            for ip in ips:
                tab[row[u32(ip)], self.col[n]] = True
        self.tab = tab.to(device)

    def rows(self, ip: torch.Tensor) -> torch.Tensor:
        n = self.keys.shape[0]
        if n == 0:
            return torch.full_like(ip, 0)
        pos = torch.searchsorted(self.keys, ip.contiguous()).clamp(max=n - 1)
        return torch.where(self.keys[pos] == ip, pos, n)


def _pad(rows: list, fill, device) -> torch.Tensor:
    k = max([1] + [len(r) for r in rows])
    return torch.tensor([list(r) + [fill] * (k - len(r)) for r in rows],
                        dtype=torch.long, device=device).reshape(len(rows), k)


class _Direction:
    """One direction's rules in evaluation order (phase 1: non-baseline
    Antrea-native; the K8s rules; the baseline tier), and for each address
    that a rule applies to, the positions of the rules that apply to it,
    ascending: a lane tests only its own pod's rules."""

    def __init__(self, d: str, pols: list, at: _Members, ag: _Members,
                 ids: dict, device):
        ph1, k8s, base = [], [], []
        for p in pols:
            for i, r in enumerate(p["rules"]):
                if r["direction"] != d:
                    continue
                item = (p, i, r)
                if p["k8s"]:
                    k8s.append(item)
                else:
                    key = (p["tier"], p["priority"], r["priority"], p["uid"])
                    (base if p["tier"] == TIER_BASELINE else ph1).append(
                        (key, item))
        ph1 = [it for _, it in sorted(ph1, key=lambda t: t[0])]
        base = [it for _, it in sorted(base, key=lambda t: t[0])]
        rules = ph1 + k8s + base
        self.n1, self.nk = len(ph1), len(k8s)
        by_group: dict = {}
        grp, blk, sv, svany, act, rid, anyp = [], [], [], [], [], [], []
        for pos, (p, i, r) in enumerate(rules):
            name = f"{p['uid']}/{r['direction']}/{i}"
            rid.append(ids.setdefault(name, len(ids)))
            act.append(_ACT[r["action"]])
            for g in (r["applied_to"] or p["applied_to"]):
                if g in at.col:
                    by_group.setdefault(at.col[g], []).append(pos)
            peer = r["peer"]
            anyp.append(not peer["groups"] and not peer["blocks"])
            grp.append([ag.col[g] for g in peer["groups"] if g in ag.col])
            blk.append([x for c, exc in peer["blocks"]
                        for x in block_ranges(c, exc)])
            svany.append(not r["services"])
            sv.append([(-1 if s["proto"] is None else s["proto"],
                        s["port"] is not None, s["port"] or 0,
                        (s["end_port"] if s["end_port"] is not None
                         else s["port"] or 0)) for s in r["services"]])
        n = self.rules = len(rules)
        # Row n: a rule that matches nothing, the candidate lists' filler.
        anyp.append(False)
        svany.append(False)
        grp.append([])
        blk.append([])
        sv.append([])
        act.append(ALLOW)
        rid.append(-1)
        self.grp = _pad(grp, -1, device)
        self.blo = _pad([[lo for lo, _ in b] for b in blk], 0, device)
        self.bhi = _pad([[hi for _, hi in b] for b in blk], 0, device)
        self.any_peer = torch.tensor(anyp, dtype=torch.bool, device=device)
        self.sv_any = torch.tensor(svany, dtype=torch.bool, device=device)
        self.sp = _pad([[s[0] for s in x] for x in sv], -2, device)
        self.shas = _pad([[int(s[1]) for s in x] for x in sv], 0, device) != 0
        self.slo = _pad([[s[2] for s in x] for x in sv], 0, device)
        self.shi = _pad([[s[3] for s in x] for x in sv], 0, device)
        self.act = torch.tensor(act, dtype=torch.long, device=device)
        self.rid = torch.tensor(rid, dtype=torch.long, device=device)
        # A rule whose phase and match condition an earlier candidate of
        # the same address repeats can never be that address's first
        # match: the lists leave it out.
        phase = [0] * self.n1 + [1] * self.nk + [2] * (n - self.n1 - self.nk)
        sig = [(phase[i], anyp[i], tuple(grp[i]), tuple(blk[i]), svany[i],
                tuple(sv[i])) for i in range(n)]
        tab = at.tab.cpu().numpy()
        lists = []
        for row in tab:
            got = [by_group.get(int(g), []) for g in np.nonzero(row)[0]]
            seen, keep = set(), []
            for pos in (np.unique(np.concatenate(got)).tolist()
                        if any(got) else []):
                if sig[pos] not in seen:
                    seen.add(sig[pos])
                    keep.append(pos)
            lists.append(keep)
        self.cand = _pad(lists, n, device)


def _first(m: torch.Tensor):
    """-> (any match, index of the first match) along the last axis."""
    return m.any(dim=1), m.to(torch.uint8).argmax(dim=1)


class Classifier:
    def __init__(self, plain: dict, device):
        pols = plain["policies"]
        for g in plain["address_groups"].values():
            if g["blocks"]:
                raise NotImplementedError("address groups with ipBlocks")
        for p in pols:
            for r in p["rules"]:
                if r["peer"]["to_services"] or r["l7"] or any(
                        s["port_name"] or s["icmp_type"] is not None
                        for s in r["services"]):
                    raise NotImplementedError(
                        "toServices peers, L7 rules, named ports, ICMP types")
        self.at = _Members(plain["applied_to_groups"], device)
        self.ag = _Members({n: g["ips"] for n, g in
                            plain["address_groups"].items()}, device)
        ids: dict = {}
        self.dirs = {d: _Direction(d, pols, self.at, self.ag, ids, device)
                     for d in ("In", "Out")}
        self.ids = [None] * len(ids)
        for name, i in ids.items():
            self.ids[i] = name
        self.index = ids
        # Pods a K8s policy isolates, per direction (the last row: none).
        self.iso = {}
        for d in ("In", "Out"):
            iso = torch.zeros(self.at.tab.shape[0], dtype=torch.bool)
            for p in pols:
                if p["k8s"] and d in p["policy_types"]:
                    for g in p["applied_to"]:
                        if g in self.at.col:
                            iso |= self.at.tab[:, self.at.col[g]].cpu()
            self.iso[d] = iso.to(device)

    def _direction(self, d: str, pod, peer, proto, dport):
        D = self.dirs[d]
        prow = self.at.rows(pod)
        c = D.cand[prow]                                  # (L, K)
        hit = D.any_peer[c]
        qrow = self.ag.rows(peer)[:, None]
        for j in range(D.grp.shape[1]):
            g = D.grp[:, j][c]
            hit |= self.ag.tab[qrow, g.clamp(min=0)] & (g >= 0)
        ip = peer[:, None]
        for k in range(D.blo.shape[1]):
            hit |= (ip >= D.blo[:, k][c]) & (ip < D.bhi[:, k][c])
        sv = D.sv_any[c]
        portful = torch.zeros_like(proto, dtype=torch.bool)
        for p in _PORTFUL:
            portful |= proto == p
        pr, dp, pf = proto[:, None], dport[:, None], portful[:, None]
        for k in range(D.sp.shape[1]):
            sp = D.sp[:, k][c]
            ok = (sp == -1) | (sp == pr)
            ok &= (~D.shas[:, k][c] | ~pf
                   | ((dp >= D.slo[:, k][c]) & (dp <= D.shi[:, k][c])))
            sv |= ok & (sp != -2)
        m = hit & sv
        n1, nk = D.n1, D.nk
        h1, i1 = _first(m & (c < n1))
        hk, ik = _first(m & (c >= n1) & (c < n1 + nk))
        hb, ib = _first(m & (c >= n1 + nk))
        pos = torch.gather(c, 1, torch.stack([i1, ik, ib], dim=1))
        i1 = torch.where(h1, pos[:, 0], D.rules)
        ik = torch.where(hk, pos[:, 1], D.rules)
        ib = torch.where(hb, pos[:, 2], D.rules)
        a1, ab = D.act[i1], D.act[ib]
        fin1 = h1 & (a1 != PASS)
        finb = hb & (ab != PASS)
        iso = self.iso[d][prow]
        code = torch.where(fin1, a1, torch.where(
            iso, torch.where(hk, ALLOW, DROP),
            torch.where(finb, ab, ALLOW)))
        rule = torch.where(fin1, D.rid[i1], torch.where(
            iso, torch.where(hk, D.rid[ik], -1),
            torch.where(finb, D.rid[ib], -1)))
        return code, rule

    def classify(self, src, dst, proto, dport):
        """Post-DNAT tuples (int64 u32 values) -> (code, ingress rule,
        egress rule): rule numbers into self.ids, -1 for none."""
        out = []
        for lo in range(0, src.shape[0], BLOCK):
            s, t = src[lo:lo + BLOCK], dst[lo:lo + BLOCK]
            p, q = proto[lo:lo + BLOCK], dport[lo:lo + BLOCK]
            eg, r_out = self._direction("Out", s, t, p, q)
            ig, r_in = self._direction("In", t, s, p, q)
            out.append((torch.where(eg != ALLOW, eg, ig), r_in, r_out))
        if not out:
            z = torch.zeros(0, dtype=torch.long, device=src.device)
            return z, z, z
        return tuple(torch.cat(c) for c in zip(*out))
