"""BGP controller: BGPPolicy -> per-node RIB + peer session model.

The analog of pkg/agent/controller/bgp (3,345 LoC): the
BGPPolicy CRD selects nodes and declares peers (ASN, address, port) and
advertisements (Service ClusterIPs/ExternalIPs/LoadBalancerIPs, Pod CIDRs,
Egress IPs); the matching agent runs a gobgp speaker and advertises the
computed route set to each peer, withdrawing on resource deletion.

The speaker itself is external native code in the reference (gobgp's BGP
wire implementation); what the controller owns — and what is rebuilt here —
is the RECONCILIATION: resources -> advertised prefix set per peer, with
adds/withdraws computed as set deltas (bgp_controller.go reconcile:
advertisements diffing) and per-peer session state.  The wire protocol
sits behind a `speaker` callable; agent/bgp_wire.py provides the real
RFC 4271 speaker (OPEN/KEEPALIVE/UPDATE over TCP — wire_speaker opens a
session per peer), and tests prove a peer actually receives the routes
(tests/test_aux_agents.py scripted-peer session).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class BgpPeer:
    address: str
    asn: int
    port: int = 179


@dataclass
class BgpPolicy:
    """crd BGPPolicy subset (nodeSelector elided: feed only matching nodes)."""

    name: str
    local_asn: int
    listen_port: int = 179
    peers: list = field(default_factory=list)  # [BgpPeer]
    advertise_service_ips: bool = True
    advertise_pod_cidrs: bool = False
    advertise_egress_ips: bool = False


class BgpController:
    """One per node.  Feed resources; it reconciles the advertised RIB and
    emits (peer, action, prefix) events through `speaker`."""

    def __init__(self, node: str, speaker: Optional[Callable] = None):
        self._node = node
        self._policy: Optional[BgpPolicy] = None
        self._speaker = speaker or (lambda peer, action, prefix: None)
        self._service_ips: set[str] = set()
        self._pod_cidrs: set[str] = set()
        self._egress_ips: set[str] = set()
        self._advertised: dict[BgpPeer, set] = {}

    # -- resource feeds (the informer handlers) ------------------------------

    def set_policy(self, policy: Optional[BgpPolicy]) -> None:
        self._policy = policy
        self._reconcile()

    def set_service_ips(self, ips) -> None:
        self._service_ips = {f"{ip}/32" for ip in ips}
        self._reconcile()

    def set_pod_cidrs(self, cidrs) -> None:
        self._pod_cidrs = set(cidrs)
        self._reconcile()

    def set_egress_ips(self, ips) -> None:
        self._egress_ips = {f"{ip}/32" for ip in ips}
        self._reconcile()

    # -- state ---------------------------------------------------------------

    def rib(self) -> set:
        """The prefix set this node should advertise under the active
        policy (bgp_controller.go getRoutes)."""
        if self._policy is None:
            return set()
        out: set[str] = set()
        if self._policy.advertise_service_ips:
            out |= self._service_ips
        if self._policy.advertise_pod_cidrs:
            out |= self._pod_cidrs
        if self._policy.advertise_egress_ips:
            out |= self._egress_ips
        return out

    def advertised(self, peer: BgpPeer) -> set:
        return set(self._advertised.get(peer, ()))

    def sessions(self) -> list[dict]:
        """Per-peer session summary (antctl `get bgppeers` analog)."""
        if self._policy is None:
            return []
        return [
            {"peer": p.address, "asn": p.asn, "port": p.port,
             "advertised": len(self._advertised.get(p, ()))}
            for p in self._policy.peers
        ]

    def _reconcile(self) -> None:
        want = self.rib()
        peers = list(self._policy.peers) if self._policy else []
        # Withdraw everything from peers that left the policy.
        for peer in list(self._advertised):
            if peer not in peers:
                for prefix in sorted(self._advertised.pop(peer)):
                    self._speaker(peer, "withdraw", prefix)
        for peer in peers:
            have = self._advertised.setdefault(peer, set())
            for prefix in sorted(want - have):
                self._speaker(peer, "advertise", prefix)
            for prefix in sorted(have - want):
                self._speaker(peer, "withdraw", prefix)
            self._advertised[peer] = set(want)
