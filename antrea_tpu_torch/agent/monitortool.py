"""NodeLatencyMonitor: the inter-node ICMP probe mesh.

The analog of pkg/agent/monitortool (1,860 LoC;
monitor.go:63): when the NodeLatencyMonitor CRD enables it, every agent
pings every other node's gateway IP on an interval, tracks last/min/max
RTT per peer (`LatencyStore`), and publishes a NodeLatencyStats CRD entry
for its node.

The wire probe is an OS ping in the reference; here it is a pluggable
`probe(target_ip) -> rtt_seconds | None` callable (None = lost), so tests
inject deterministic fabrics and a real deployment can plug an ICMP or
TCP-connect prober.  The statistics, peer lifecycle, and report body
reproduce monitor.go's."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class PeerStats:
    """monitortool.NodeIPLatencyEntry analog."""

    target_ip: str
    last_send: int = 0
    last_recv: int = 0
    last_rtt: Optional[float] = None  # seconds; None until first success
    min_rtt: Optional[float] = None
    max_rtt: Optional[float] = None
    sent: int = 0
    lost: int = 0


class NodeLatencyMonitor:
    def __init__(
        self,
        node: str,
        probe: Callable[[str], Optional[float]],
        interval_s: int = 60,
    ):
        self._node = node
        self._probe = probe
        self.interval_s = interval_s
        self._peers: dict[str, PeerStats] = {}  # node name -> stats
        self._last_run = None

    # -- peer lifecycle (node informer handlers, monitor.go onNodeAdd/...) ---

    def upsert_peer(self, node: str, target_ip: str) -> None:
        if node == self._node:
            return
        cur = self._peers.get(node)
        if cur is None or cur.target_ip != target_ip:
            self._peers[node] = PeerStats(target_ip=target_ip)

    def delete_peer(self, node: str) -> None:
        self._peers.pop(node, None)

    # -- probe round (the ticker body) ---------------------------------------

    def tick(self, now: int) -> int:
        """One probe round over all peers, honoring the interval; -> probes
        sent (0 when the interval hasn't elapsed)."""
        if self._last_run is not None and now - self._last_run < self.interval_s:
            return 0
        self._last_run = now
        n = 0
        for st in self._peers.values():
            st.sent += 1
            st.last_send = now
            rtt = self._probe(st.target_ip)
            n += 1
            if rtt is None:
                st.lost += 1
                continue
            st.last_recv = now
            st.last_rtt = rtt
            st.min_rtt = rtt if st.min_rtt is None else min(st.min_rtt, rtt)
            st.max_rtt = rtt if st.max_rtt is None else max(st.max_rtt, rtt)
        return n

    # -- report (NodeLatencyStats CRD body, monitor.go summarize) ------------

    def report(self) -> dict:
        return {
            "nodeName": self._node,
            "peerNodeLatencyStats": [
                {
                    "nodeName": peer,
                    "targetIP": st.target_ip,
                    "lastSendTime": st.last_send,
                    "lastRecvTime": st.last_recv,
                    "lastMeasuredRTT": st.last_rtt,
                    "minRTT": st.min_rtt,
                    "maxRTT": st.max_rtt,
                    "sent": st.sent,
                    "lost": st.lost,
                }
                for peer, st in sorted(self._peers.items())
            ],
        }
