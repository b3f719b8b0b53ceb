"""Node-0's output decision for a packet's effective destination, from its
topology: SpoofGuard on pod ports, then multicast (no group joined: drop),
a local pod (its port), a remote node's pod CIDR (the tunnel, toward that
node's IP), an unknown address in the local pod CIDR (drop), else the
gateway.  The kind and port numbers are the datapath's encoding."""

from __future__ import annotations

import torch

from .ip import cidr_range, u32

LOCAL, TUNNEL, GATEWAY, DROP_SPOOF, DROP_UNKNOWN, MCAST = 0, 1, 2, 3, 4, 5
DROP_MCAST, PUNT = 6, 7
OFPORT_TUNNEL, OFPORT_GATEWAY, FIRST_POD_OFPORT = 1, 2, 3
MC_LO, MC_HI = 0xE0000000, 0xEFFFFFFF


class Forwarding:
    def __init__(self, plain: dict, device):
        if plain["extra"]:
            raise NotImplementedError(
                "TrafficControl, multicast groups, v6: the reference "
                "forwards a v4 node without them")
        pods = sorted((u32(ip), port) for ip, port in plain["local_pods"])
        rn = sorted((*cidr_range(c), u32(ip))
                    for c, ip in plain["remote_nodes"])
        for a, b in zip(rn, rn[1:]):
            if b[0] < a[1]:
                raise ValueError("overlapping remote pod CIDRs")

        def t(x):
            return torch.tensor(x, dtype=torch.long, device=device)

        self.lp_ip = t([ip for ip, _ in pods] + [1 << 40])
        self.lp_port = t([p for _, p in pods] + [-1])
        self.rn_lo = t([lo for lo, _, _ in rn] + [1 << 40])
        self.rn_hi = t([hi for _, hi, _ in rn] + [1 << 40])
        self.rn_peer = t([ip for _, _, ip in rn] + [0])
        self.local = cidr_range(plain["pod_cidr"]) if plain["pod_cidr"] \
            else (1 << 40, 1 << 40)

    def local_pod(self, ip):
        """-> (is a local pod, its ofport)."""
        row = torch.searchsorted(self.lp_ip, ip)
        known = self.lp_ip[row] == ip
        return known, torch.where(known, self.lp_port[row], -1)

    def lookup(self, dst):
        """-> (kind, out port, tunnel peer)."""
        local, port = self.local_pod(dst)
        r = torch.searchsorted(self.rn_lo, dst, right=True) - 1
        rs = r.clamp(min=0)
        in_rn = (r >= 0) & (dst < self.rn_hi[rs])
        in_cidr = (dst >= self.local[0]) & (dst < self.local[1])
        mc = (dst >= MC_LO) & (dst <= MC_HI)
        kind = torch.where(mc, DROP_MCAST, torch.where(
            local, LOCAL, torch.where(in_rn, TUNNEL, torch.where(
                in_cidr, DROP_UNKNOWN, GATEWAY))))
        out = torch.where(mc, -1, torch.where(local, port, torch.where(
            in_rn, OFPORT_TUNNEL, torch.where(in_cidr, -1, OFPORT_GATEWAY))))
        peer = torch.where(in_rn & ~local & ~mc, self.rn_peer[rs], 0)
        return kind, out, peer
