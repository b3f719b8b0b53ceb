"""Packet-in dispatcher: per-category rate-limited punt queues.

The analog of the reference's packet-in plumbing
(pkg/agent/openflow/packetin.go:44-55 categories TF / NP /
DNS / IGMP / SvcReject; :101-130 per-category rate-limited workers): the
dataplane punts packets to the controller at a bounded rate per category so
a punt storm (an IGMP flood, a reject storm) cannot starve the others or
the control plane.

Here the "punt" sources are columns of a StepResult (the kernel never
blocks on the host): `collect()` derives category items from a stepped
batch, `submit()` applies the per-category token bucket, and registered
handlers drain synchronously via `drain()` — the worker-goroutine analog in
a single-threaded test world.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

# Categories (packetin.go:44-55).
CAT_TRACEFLOW = "TF"
CAT_NETWORKPOLICY = "NP"  # reject/log synthesis (reject.go, audit_logging.go)
CAT_DNS = "DNS"  # FQDN feedback loop (fqdn.go)
CAT_IGMP = "IGMP"  # multicast membership (pkg/agent/multicast)
CAT_SVCREJECT = "SvcReject"  # no-endpoint service reject

DEFAULT_RATE = 100  # items/second per category (packetin.go rate limiters)
DEFAULT_BURST = 200


@dataclass
class _Bucket:
    rate: int
    burst: int
    tokens: float = field(default=0.0)
    last: int = field(default=0)
    dropped: int = 0
    queue: deque = field(default_factory=deque)

    def admit(self, now: int) -> bool:
        self.tokens = min(
            self.burst, self.tokens + (now - self.last) * self.rate
        )
        self.last = now
        if self.tokens >= 1:
            self.tokens -= 1
            return True
        self.dropped += 1
        return False


class PacketInDispatcher:
    def __init__(self, rate: int = DEFAULT_RATE, burst: int = DEFAULT_BURST):
        self._buckets: dict[str, _Bucket] = {}
        self._handlers: dict[str, list] = {}
        self._rate = rate
        self._burst = burst

    def _bucket(self, category: str) -> _Bucket:
        b = self._buckets.get(category)
        if b is None:
            b = self._buckets[category] = _Bucket(self._rate, self._burst,
                                                  tokens=self._burst)
        return b

    def register(self, category: str, handler) -> None:
        self._handlers.setdefault(category, []).append(handler)

    def submit(self, category: str, item: dict, now: int) -> bool:
        """-> admitted?  Rejected items are counted, not queued (the
        reference's rate.Limiter.Allow() drop, packetin.go:120)."""
        b = self._bucket(category)
        if not b.admit(now):
            return False
        b.queue.append(item)
        return True

    def drain(self, now: int) -> int:
        """Dispatch all queued items to their handlers; -> items handled."""
        n = 0
        for cat, b in self._buckets.items():
            while b.queue:
                item = b.queue.popleft()
                for h in self._handlers.get(cat, ()):  # no handler: drop
                    h(item, now)
                n += 1
        return n

    def dropped(self, category: str) -> int:
        return self._bucket(category).dropped

    def collect(self, batch, result, now: int) -> int:
        """Derive punt items from a stepped batch (the packet-in parse,
        packetin.go:132 parsePacketIn): IGMP punts and REJECT synthesis
        events.  -> items admitted."""
        n = 0
        punt = result.punt
        if punt is not None:
            for i in punt.nonzero()[0]:
                item = {
                    "in_port": int(batch.in_ports()[i]),
                    "src_ip": int(batch.src_ip[i]),
                    "group_ip": int(batch.dst_ip[i]),
                    # IGMP payload kind is carried in src_port by the
                    # simulator (no L4 for IGMP): 0x16 v2 report (join),
                    # 0x17 v2 leave — the wire message types.
                    "kind": int(batch.src_port[i]),
                }
                n += self.submit(CAT_IGMP, item, now)
        if result.reject_kind is not None:
            for i in result.reject_kind.nonzero()[0]:
                cat = (
                    CAT_SVCREJECT
                    if result.svc_idx is not None and result.svc_idx[i] >= 0
                    and result.ingress_rule[i] is None
                    and result.egress_rule[i] is None
                    else CAT_NETWORKPOLICY
                )
                n += self.submit(cat, {
                    "src_ip": int(batch.src_ip[i]),
                    "dst_ip": int(batch.dst_ip[i]),
                    "reject_kind": int(result.reject_kind[i]),
                    "rule": result.ingress_rule[i] or result.egress_rule[i],
                }, now)
        return n
