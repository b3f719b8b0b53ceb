"""IP assigner: VIP interface assignment + gratuitous-ARP announcements.

The analog of pkg/agent/ipassigner (2,679 LoC): the agent
that WINS an Egress/ServiceExternalIP election assigns the VIP to a local
interface and broadcasts gratuitous ARP so the fabric learns the new
location — and the loser removes it.  (The reference also handles IPv6
unsolicited NA; this build's datapath is IPv4-only, so non-IPv4 VIPs are
rejected up front.)  The netlink/socket work is host-native; the product
logic rebuilt here is the assignment reconcile: idempotent
assign/unassign, the announcement events (repeat count per the
reference), and the ownership-flip sequencing a failover produces —
announcements carry the OWNING NODE's MAC, which is what actually moves
the VIP in neighbor caches on failover."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

ANNOUNCE_REPEATS = 3  # ref ipassigner arpAnnounceCount


def node_mac(node: str) -> str:
    """Deterministic locally-administered MAC for a NODE identity (the
    announced MAC must identify the current owner, not the VIP)."""
    d = hashlib.sha256(b"antrea-tpu-node-mac:" + node.encode()).digest()
    return "0a:01:%02x:%02x:%02x:%02x" % tuple(d[:4])


@dataclass(frozen=True)
class Announcement:
    ip: str
    mac: str
    kind: str = "gratuitous-arp"


class IPAssigner:
    def __init__(
        self,
        node: str,
        announce: Optional[Callable[[Announcement], None]] = None,
    ):
        self._node = node
        self._mac = node_mac(node)
        self._announce = announce or (lambda a: None)
        self._assigned: set[str] = set()

    def assign(self, ip: str) -> bool:
        """Idempotently assign a VIP; announces on the FIRST assignment
        only (re-sync of an already-held IP is silent, like the
        reference's assigner skipping present addresses)."""
        from ..utils import ip as iputil

        iputil.ip_to_u32(ip)  # validate (IPv4-only) BEFORE mutating
        if ip in self._assigned:
            return False
        self._assigned.add(ip)
        ann = Announcement(ip=ip, mac=self._mac)
        for _ in range(ANNOUNCE_REPEATS):
            self._announce(ann)
        return True

    def unassign(self, ip: str) -> bool:
        if ip not in self._assigned:
            return False
        self._assigned.discard(ip)
        return True

    def assigned(self) -> set:
        return set(self._assigned)

    def reconcile(self, want: set) -> tuple[set, set]:
        """Drive the held set to `want` (the memberlist-event handler body:
        election results in, assignments out); -> (added, removed)."""
        added = {ip for ip in sorted(want - self._assigned) if self.assign(ip)}
        removed = {
            ip for ip in sorted(self._assigned - want) if self.unassign(ip)
        }
        return added, removed
