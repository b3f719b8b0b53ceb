"""NodePortLocal: per-pod node-port mappings with a persisted port cache.

The analog of pkg/agent/nodeportlocal (3,654 LoC):
`k8s/npl_controller.go` watches pods behind NPL-enabled services and
allocates one node port per (pod IP, protocol, pod port) from a configured
range (`portcache/port_table.go`, default range in npl_agent_init.go:39);
the mapping is realized as an iptables DNAT rule on the node and advertised
via the pod annotation `nodeportlocal.antrea.io` so external load balancers
can target pods directly through node ports.

TPU build: a mapping IS a single-endpoint LB frontend — (node IP, proto,
npl port) -> DNAT to (pod IP, pod port), client IP preserved (no SNAT),
exactly the iptables DNAT semantics — so the port cache compiles into the
same ServiceLB tensors as AntreaProxy frontends (compiler/services.py) and
the established-connection/reply/un-DNAT machinery applies unchanged.

Restart recovery mirrors portcache's rule restore: allocations persist as
rows in the native config store and are re-claimed on boot, so a pod's
advertised node port never changes across an agent restart.
"""

from __future__ import annotations

import json
from typing import Optional

from ..apis.service import Endpoint, ServiceEntry

# Reference default range (build/charts antrea-agent.conf nplPortRange).
DEFAULT_PORT_RANGE = (61000, 62000)

_KEY_PREFIX = "npl/"


class PortAllocationError(Exception):
    pass


class NplController:
    def __init__(
        self,
        node_ips: list[str],
        port_range: tuple[int, int] = DEFAULT_PORT_RANGE,
        store=None,  # native ConfigStore for restart persistence
    ):
        self._node_ips = list(node_ips)
        self._lo, self._hi = port_range
        self._store = store
        # (pod_ip, proto, pod_port) -> npl node port
        self._map: dict[tuple[str, int, int], int] = {}
        self._used: set[int] = set()
        self._cursor = self._lo
        if store is not None:
            for key in store.keys():
                if not key.startswith(_KEY_PREFIX):
                    continue
                row = json.loads(store.get(key))
                k = (row["podIP"], row["protocol"], row["podPort"])
                self._map[k] = row["nodePort"]
                self._used.add(row["nodePort"])

    # -- allocation (portcache/port_table.go GetEntry/AddRule) ---------------

    def add_pod_port(self, pod_ip: str, protocol: int, pod_port: int) -> int:
        """Allocate (idempotently) a node port for a pod port; -> node port."""
        k = (pod_ip, protocol, pod_port)
        existing = self._map.get(k)
        if existing is not None:
            return existing
        port = self._alloc()
        self._map[k] = port
        self._used.add(port)
        if self._store is not None:
            self._store.set(
                _KEY_PREFIX + f"{pod_ip}/{protocol}/{pod_port}",
                json.dumps({"podIP": pod_ip, "protocol": protocol,
                            "podPort": pod_port, "nodePort": port}).encode(),
            )
            self._store.commit()
        return port

    def remove_pod_port(self, pod_ip: str, protocol: int, pod_port: int) -> bool:
        k = (pod_ip, protocol, pod_port)
        port = self._map.pop(k, None)
        if port is None:
            return False
        self._used.discard(port)
        if self._store is not None:
            self._store.delete(_KEY_PREFIX + f"{pod_ip}/{protocol}/{pod_port}")
            self._store.commit()
        return True

    def remove_pod(self, pod_ip: str) -> int:
        """Pod deleted: release all its mappings; -> mappings released."""
        gone = [k for k in self._map if k[0] == pod_ip]
        for k in gone:
            self.remove_pod_port(*k)
        return len(gone)

    def _alloc(self) -> int:
        # Rolling cursor with wraparound (port_table.go getFreePort).
        span = self._hi - self._lo
        for off in range(span):
            p = self._lo + (self._cursor - self._lo + off) % span
            if p not in self._used:
                self._cursor = p + 1
                return p
        raise PortAllocationError(
            f"NPL port range {self._lo}-{self._hi} exhausted"
        )

    # -- dataplane + annotation surfaces -------------------------------------

    def service_entries(self) -> list[ServiceEntry]:
        """The mappings as single-endpoint LB frontends, one per node IP —
        merge these into the service bundle on install (the iptables-DNAT
        analog; client IP preserved, so no SNAT and no shadow program)."""
        out = []
        for (pod_ip, proto, pod_port), npl_port in sorted(self._map.items()):
            for nip in self._node_ips:
                out.append(ServiceEntry(
                    cluster_ip=nip,
                    port=npl_port,
                    protocol=proto,
                    endpoints=[Endpoint(ip=pod_ip, port=pod_port)],
                    name=f"npl-{pod_ip}-{pod_port}",
                    namespace="",
                ))
        return out

    def annotation(self, pod_ip: str) -> Optional[str]:
        """The `nodeportlocal.antrea.io` pod annotation body (ref
        k8s/annotations.go NPLAnnotation: podPort/nodeIP/nodePort/protocols)
        or None when the pod has no mappings."""
        rows = [
            {"podPort": pod_port, "nodeIP": self._node_ips[0] if self._node_ips else "",
             "nodePort": npl_port, "protocol": proto}
            for (ip, proto, pod_port), npl_port in sorted(self._map.items())
            if ip == pod_ip
        ]
        return json.dumps(rows) if rows else None

    def mappings(self) -> dict:
        return dict(self._map)
