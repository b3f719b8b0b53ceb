"""ExternalIPPool: IP range pools with allocation + node-selector scoping.

The analog of pkg/controller/externalippool (1,743 LoC):
the ExternalIPPool CRD declares ipRanges (start-end or CIDR) and a
nodeSelector; the controller validates pools, allocates/releases IPs for
consumers (Egress, ServiceExternalIP), and reports usage in the pool
status (`ExternalIPPoolStatus.Usage`).  The allocator here reproduces the
semantics of `externalippool.ipAllocator`: first-free in range order,
idempotent per owner, double-allocation refused, release by owner.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..utils import ip as iputil


@dataclass(frozen=True)
class IPRange:
    """start-end (inclusive) or cidr — exactly the CRD's IPRange union."""

    cidr: str = ""
    start: str = ""
    end: str = ""

    def bounds(self) -> tuple[int, int]:
        """-> [lo, hi] inclusive COMBINED-keyspace bounds (utils/ip.py —
        pools are dual-stack like the reference's ipAllocator).  v4 CIDRs
        exclude the network and broadcast addresses (prefixes < /31); v6
        CIDRs exclude the network (subnet-router anycast) address only —
        IPv6 has no broadcast."""
        if self.cidr:
            lo, hi = iputil.cidr_to_range(self.cidr)  # [lo, hi)
            if iputil.is_v6(self.cidr):
                return (lo + 1, hi - 1) if hi - lo > 1 else (lo, hi - 1)
            if hi - lo > 2:
                return lo + 1, hi - 2
            return lo, hi - 1
        lo, hi = iputil.ip_to_key(self.start), iputil.ip_to_key(self.end)
        if hi < lo:
            raise ValueError(f"range end {self.end} before start {self.start}")
        return lo, hi


@dataclass
class ExternalIPPool:
    name: str
    ip_ranges: list = field(default_factory=list)  # [IPRange]
    # nodeSelector: nodes eligible to host this pool's IPs (matched against
    # node labels by the consumer's failover scheduler).
    node_selector: Optional[object] = None


class PoolExhaustedError(Exception):
    pass


class ExternalIPPoolController:
    def __init__(self):
        self._pools: dict[str, ExternalIPPool] = {}
        # pool -> {ip key -> owner} (combined keyspace int)
        self._alloc: dict[str, dict[int, str]] = {}
        # pool -> rolling next-candidate position (O(1) amortized sequential
        # allocation — the same wrap-around-cursor discipline as
        # agent/cni.HostLocalIPAM; exhaustion is a count check, never a
        # range scan).
        self._cursor: dict[str, int] = {}

    def upsert(self, pool: ExternalIPPool) -> None:
        # Validate ranges before committing; overlapping ranges are refused
        # (they would double-count capacity and break the count-based
        # exhaustion check) and shrinking a pool below its current
        # allocations is refused — both mirror the reference's validation
        # webhook on ExternalIPPool updates.
        bounds = [r.bounds() for r in pool.ip_ranges]
        for a, b in zip(sorted(bounds), sorted(bounds)[1:]):
            if b[0] <= a[1]:
                raise ValueError(
                    f"pool {pool.name}: overlapping ipRanges "
                    f"{iputil.key_to_ip(a[0])}-{iputil.key_to_ip(a[1])} and "
                    f"{iputil.key_to_ip(b[0])}-{iputil.key_to_ip(b[1])}"
                )
        used = self._alloc.get(pool.name, {})
        for ip in used:
            if not any(lo <= ip <= hi for lo, hi in bounds):
                raise ValueError(
                    f"pool {pool.name}: range update strands allocated "
                    f"{iputil.key_to_ip(ip)}"
                )
        self._pools[pool.name] = pool
        self._alloc.setdefault(pool.name, {})

    def delete(self, name: str) -> None:
        if self._alloc.get(name):
            raise ValueError(f"pool {name} has live allocations")
        self._pools.pop(name, None)
        self._alloc.pop(name, None)

    def allocate(self, pool_name: str, owner: str,
                 ip: Optional[str] = None) -> str:
        """Allocate (idempotently per owner) an IP; a specific `ip` request
        pins it (the static-EgressIP case) or errors if taken."""
        pool = self._pools.get(pool_name)
        if pool is None:
            raise KeyError(f"unknown pool {pool_name}")
        table = self._alloc[pool_name]
        held = next((u for u, o in table.items() if o == owner), None)
        if held is not None:
            if ip is not None and iputil.ip_to_key(ip) != held:
                raise ValueError(
                    f"{owner} already holds {iputil.key_to_ip(held)}"
                )
            return iputil.key_to_ip(held)
        if ip is not None:
            u = iputil.ip_to_key(ip)
            if not any(lo <= u <= hi for lo, hi in
                       (r.bounds() for r in pool.ip_ranges)):
                raise ValueError(f"{ip} outside pool {pool_name}")
            if u in table:
                raise ValueError(f"{ip} already allocated to {table[u]}")
            table[u] = owner
            return ip
        bounds = [r.bounds() for r in pool.ip_ranges]
        total = sum(hi - lo + 1 for lo, hi in bounds)
        if len(table) >= total:
            raise PoolExhaustedError(f"pool {pool_name} exhausted")
        # Resume from the cursor; at least one free slot exists, so the
        # walk terminates after skipping the (bounded) allocated run.
        flat_pos = self._cursor.get(pool_name, 0) % total
        while True:
            u = self._flat_to_key(bounds, flat_pos)
            flat_pos = (flat_pos + 1) % total
            if u not in table:
                table[u] = owner
                self._cursor[pool_name] = flat_pos
                return iputil.key_to_ip(u)

    @staticmethod
    def _flat_to_key(bounds: list, pos: int) -> int:
        for lo, hi in bounds:
            n = hi - lo + 1
            if pos < n:
                return lo + pos
            pos -= n
        raise IndexError(pos)

    def release(self, pool_name: str, owner: str) -> Optional[str]:
        table = self._alloc.get(pool_name, {})
        for u, o in list(table.items()):
            if o == owner:
                del table[u]
                return iputil.key_to_ip(u)
        return None

    def usage(self, pool_name: str) -> dict:
        """ExternalIPPoolStatus.Usage analog."""
        pool = self._pools[pool_name]
        total = sum(hi - lo + 1 for lo, hi in
                    (r.bounds() for r in pool.ip_ranges))
        used = len(self._alloc.get(pool_name, {}))
        return {"total": total, "used": used}

    def eligible_nodes(self, pool_name: str, nodes: dict) -> set:
        """nodes: {name -> labels}; -> names matching the pool's
        nodeSelector (all nodes when unset)."""
        pool = self._pools[pool_name]
        if pool.node_selector is None:
            return set(nodes)
        return {n for n, labels in nodes.items()
                if pool.node_selector.matches(labels)}
