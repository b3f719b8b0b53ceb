"""ClusterIP Service load balancing with ClientIP affinity.

A lane whose (dst, protocol, port) is a Service's frontend goes to one of
its endpoints: the one its client is pinned to, while the pin is younger
than the Service's affinity timeout and still names an endpoint, else the
endpoint at (flow hash & 0x7FFFFFFF) mod the endpoint count, and that
choice pins the client.  A Service without endpoints rejects.  The pins
live in a direct-mapped table of `aff_slots` rows, hashed over (client,
Service)."""

from __future__ import annotations

import torch

from .hashing import fnv_mix
from .ip import u32


class ServiceLB:
    def __init__(self, plain: list, device):
        keys, n_ep, base, aff, ep_ip, ep_port = [], [], [], [], [], []
        for i, s in enumerate(plain):
            if s["external"]:
                raise NotImplementedError(
                    "external IPs, NodePorts, DSR: the reference serves "
                    "ClusterIP frontends only")
            keys.append(((u32(s["ip"]) << 24) | (s["proto"] << 16)
                         | s["port"], i))
            base.append(len(ep_ip))
            n_ep.append(len(s["endpoints"]))
            aff.append(s["affinity_s"])
            for ip, port in s["endpoints"]:
                ep_ip.append(u32(ip))
                ep_port.append(port)
        keys.sort()
        for a, b in zip(keys, keys[1:]):
            if a[0] == b[0]:
                raise ValueError("duplicate Service frontend")

        def t(x):
            return torch.tensor(x, dtype=torch.long, device=device)

        self.n = len(plain)
        self.keys = t([k for k, _ in keys])
        self.idx = t([i for _, i in keys])
        self.n_ep, self.base, self.aff = t(n_ep), t(base), t(aff)
        self.ep_ip, self.ep_port = t(ep_ip + [0]), t(ep_port + [0])

    def resolve(self, src, dst, proto, dport, h, aff_state, aff_slots,
                now: int) -> dict:
        """-> svc (-1: none), no_ep, dnat_ip, dnat_port, and the pin each
        lane would learn (learn mask, aff slot, endpoint column)."""
        if self.n == 0:
            none = torch.zeros_like(src, dtype=torch.bool)
            return dict(svc=torch.full_like(src, -1), no_ep=none,
                        dnat_ip=dst, dnat_port=dport, learn=none,
                        aslot=torch.zeros_like(src), ep_col=src * 0)
        key = (dst << 24) | (proto << 16) | dport
        pos = torch.searchsorted(self.keys, key).clamp(max=self.n - 1)
        svc = torch.where(self.keys[pos] == key, self.idx[pos], -1)
        is_svc = svc >= 0
        safe = svc.clamp(min=0)
        n_ep = self.n_ep[safe]
        no_ep = is_svc & (n_ep == 0)
        aff_on = is_svc & (self.aff[safe] > 0)
        client, a_svc, a_ep, a_ts = aff_state
        aslot = fnv_mix([src, safe]) & (aff_slots - 1)
        pin = a_ep[aslot]
        pinned = (aff_on & (pin > 0) & (pin - 1 < n_ep)
                  & (client[aslot] == src) & (a_svc[aslot] == svc)
                  & ((now - a_ts[aslot]) <= self.aff[safe]))
        hash_ep = (h & 0x7FFFFFFF) % n_ep.clamp(min=1)
        ep_col = torch.where(pinned, pin - 1, hash_ep)
        use = is_svc & ~no_ep
        e = torch.where(use, self.base[safe] + ep_col, self.ep_ip.shape[0] - 1)
        return dict(svc=svc, no_ep=no_ep,
                    dnat_ip=torch.where(use, self.ep_ip[e], dst),
                    dnat_port=torch.where(use, self.ep_port[e], dport),
                    learn=aff_on & ~pinned & ~no_ep, aslot=aslot,
                    ep_col=ep_col)
