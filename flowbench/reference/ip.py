"""IPv4 ranges for the reference: half-open [lo, hi) on the u32 line."""

from __future__ import annotations

import ipaddress


def u32(ip: str) -> int:
    if ":" in ip:
        raise NotImplementedError("the reference is v4-only")
    return int(ipaddress.IPv4Address(ip))


def cidr_range(cidr: str) -> tuple[int, int]:
    net = ipaddress.IPv4Network(cidr, strict=False)
    lo = int(net.network_address)
    return lo, lo + net.num_addresses


def block_ranges(cidr: str, excepts) -> list[tuple[int, int]]:
    """A CIDR minus its excepts -> disjoint ranges."""
    lo, hi = cidr_range(cidr)
    holes = sorted(cidr_range(e) for e in excepts)
    out, cur = [], lo
    for hlo, hhi in holes:
        hlo, hhi = max(hlo, lo), min(hhi, hi)
        if hlo >= hhi:
            continue
        if cur < hlo:
            out.append((cur, hlo))
        cur = max(cur, hhi)
    if cur < hi:
        out.append((cur, hi))
    return out
