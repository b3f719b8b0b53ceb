"""Agent membership + consistent-hash ownership election.

The analog of the reference's memberlist cluster
(pkg/agent/memberlist/cluster.go:89-104 — hashicorp
memberlist gossip among agents; consistent-hash owner election via
pkg/agent/consistenthash for Egress/ServiceExternalIP failover): which
ALIVE node owns a given egress IP is a pure function of the alive set and
the key, so every agent independently elects the same owner and ownership
moves deterministically when membership changes.

The gossip transport lives in agent/gossip.py (SWIM over UDP: probe,
indirect probe, suspect/dead, piggybacked membership — cluster.go:180
memberlist.Create / :227 Join): a SwimNode feeds this cluster's
join/leave on DETECTED transitions, so Egress/ServiceExternalIP/
MC-gateway failover triggers on real death, not an operator's leave()
call (tests/test_gossip.py kills a process and observes re-election).
The consistent hash ring here is the load-bearing election semantics:
virtual nodes on a ring, owner = first node clockwise of the key's hash
(ref consistenthash.New/Get).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Callable, Optional

_VNODES = 50  # virtual nodes per member (ref consistenthash default weight)


def _h(s: str) -> int:
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


class ConsistentHash:
    """Ring with virtual nodes; Get(key) -> member (ref consistenthash)."""

    def __init__(self, members: list[str]):
        self._ring: list[tuple[int, str]] = []
        for m in members:
            for v in range(_VNODES):
                self._ring.append((_h(f"{m}#{v}"), m))
        self._ring.sort()
        self._points = [p for p, _ in self._ring]

    def get(self, key: str) -> Optional[str]:
        if not self._ring:
            return None
        i = bisect.bisect(self._points, _h(key)) % len(self._ring)
        return self._ring[i][1]


class MemberlistCluster:
    """Alive-set tracking + deterministic ownership election.

    should_own(node, key) is the reference's Cluster.ShouldSelectIP: true
    iff the consistent hash elects `node` for `key` among alive members.
    """

    def __init__(self, node: str):
        self.node = node
        self._alive: set[str] = {node}
        self._hash = ConsistentHash(sorted(self._alive))
        self._handlers: list[Callable[[set], None]] = []

    def add_event_handler(self, fn: Callable[[set], None]) -> None:
        """fn(alive_set) fires on every membership change (the reference's
        cluster node-event channel driving Egress reconciles)."""
        self._handlers.append(fn)

    def _changed(self) -> None:
        self._hash = ConsistentHash(sorted(self._alive))
        for fn in self._handlers:
            fn(set(self._alive))

    def join(self, node: str) -> None:
        if node not in self._alive:
            self._alive.add(node)
            self._changed()

    def leave(self, node: str) -> None:
        if node in self._alive:
            self._alive.discard(node)
            self._changed()

    @property
    def alive(self) -> set[str]:
        return set(self._alive)

    def owner_of(self, key: str) -> Optional[str]:
        return self._hash.get(key)

    def should_own(self, key: str) -> bool:
        return self.owner_of(key) == self.node
