"""ServiceExternalIP: LoadBalancer IP assignment with node failover.

The analog of pkg/controller/serviceexternalip (1,065 LoC;
allocates an external IP from an ExternalIPPool for LoadBalancer Services
with `service.antrea.io/external-ip-pool`) plus the agent side
(pkg/agent/controller/serviceexternalip, 1,227 LoC: each agent runs the
memberlist consistent-hash election over the pool's eligible nodes and the
winner assigns the IP to its interface and answers ARP — ipassigner).

Here: the central half allocates from ExternalIPPoolController; the agent
half (`owner_for`) elects the host node among pool-eligible alive members
with the same consistent hash the Egress feature uses, and the service's
external IP becomes a dataplane frontend by injecting it into the
ServiceEntry's external_ips (the LoadBalancer status.ingress analog)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..agent.memberlist import ConsistentHash
from .externalippool import ExternalIPPoolController


@dataclass
class ExternalIPAssignment:
    service: str  # "ns/name"
    ip: str
    pool: str
    owner: Optional[str]  # node currently hosting the IP (None: no node)


class ServiceExternalIPController:
    def __init__(self, pools: ExternalIPPoolController):
        self._pools = pools
        # service key -> (pool, ip)
        self._assigned: dict[str, tuple[str, str]] = {}

    def assign(self, service_key: str, pool_name: str,
               requested_ip: Optional[str] = None) -> str:
        """Allocate (idempotently) this service's external IP — the
        loadBalancerIP/spec.loadBalancerClass admission path."""
        owner = f"svc:{service_key}"
        held = self._assigned.get(service_key)
        if held is not None:
            pool, ip = held
            if pool == pool_name and (requested_ip in (None, ip)):
                return ip
            # Pool or pinned-IP change: release-then-reallocate, with
            # rollback — a failed re-allocation (unknown/exhausted pool,
            # pinned IP taken) must leave the service holding its previous
            # IP, never stripped.  Single-threaded controller: nothing can
            # claim the released IP between release and rollback.
            self._pools.release(pool, owner)
            del self._assigned[service_key]
            try:
                new_ip = self._pools.allocate(
                    pool_name, owner, ip=requested_ip
                )
            except Exception:
                self._pools.allocate(pool, owner, ip=ip)
                self._assigned[service_key] = (pool, ip)
                raise
            self._assigned[service_key] = (pool_name, new_ip)
            return new_ip
        ip = self._pools.allocate(pool_name, owner, ip=requested_ip)
        self._assigned[service_key] = (pool_name, ip)
        return ip

    def unassign(self, service_key: str) -> Optional[str]:
        held = self._assigned.pop(service_key, None)
        if held is None:
            return None
        pool, _ip = held
        return self._pools.release(pool, f"svc:{service_key}")

    def owner_for(self, service_key: str, alive_nodes, nodes: dict) -> "ExternalIPAssignment | None":
        """Agent-side election: the external IP is hosted by the consistent-
        hash winner among pool-eligible ALIVE nodes (failover = the hash
        re-evaluated on membership change — memberlist event handlers in
        the reference's agent, service_external_ip_controller.go)."""
        held = self._assigned.get(service_key)
        if held is None:
            return None
        pool, ip = held
        eligible = self._pools.eligible_nodes(pool, nodes) & set(alive_nodes)
        owner = ConsistentHash(sorted(eligible)).get(ip) if eligible else None
        return ExternalIPAssignment(
            service=service_key, ip=ip, pool=pool, owner=owner
        )

    def assignments(self) -> list[tuple[str, str, str]]:
        return sorted(
            (k, pool, ip) for k, (pool, ip) in self._assigned.items()
        )
