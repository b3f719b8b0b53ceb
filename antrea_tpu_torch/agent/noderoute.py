"""Agent node-route + topology controller.

The analog of three reference agents that together own a node's forwarding
state:
  * pkg/agent/controller/noderoute/node_route_controller.go — watches Nodes,
    installs per-remote-Node tunnel/route/ARP flows;
  * pkg/agent/cniserver + interfacestore — local pod ofport bindings;
  * pkg/agent/controller/trafficcontrol — TrafficControl CRD marks.

Here all three reconcile into ONE immutable `Topology` value that is
atomically swapped into the datapath (`install_topology` — the bundle
analog for the forwarding plane).  Reconciliation is edge-triggered and
idempotent: every mutation rebuilds the Topology from the controller's own
maps and reinstalls; the datapath compile is O(n log n) in pods+nodes and
swap-atomic, so there is no partial-install window (the reference needs
flow bundles for the same guarantee).
"""

from __future__ import annotations

from typing import Optional

from ..compiler.topology import NodeRoute, Topology, TrafficControlRule


class NodeRouteController:
    def __init__(
        self,
        datapath,
        node_name: str,
        pod_cidr: str = "",
        gateway_ip: str = "",
    ):
        self._dp = datapath
        self._node_name = node_name
        self._pod_cidr = pod_cidr
        self._gateway_ip = gateway_ip
        self._nodes: dict[str, NodeRoute] = {}
        self._pods: dict[str, int] = {}  # pod ip -> ofport
        self._tc: dict[str, TrafficControlRule] = {}
        self._mcast: list = []  # [McastGroup], owned by MulticastController
        # No install at construction: the datapath may hold a
        # snapshot-restored topology, and clobbering it with this (still
        # empty) view would blackhole forwarding until the first
        # sync_interfaces/upsert_node repopulates — the reference likewise
        # keeps existing flows until FlowRestoreComplete (agent.go:597).

    # -- Node watch (ref node_route_controller.go processNextWorkItem) ------

    def upsert_node(self, name: str, node_ip: str, pod_cidr: str) -> None:
        """A remote Node appeared or changed; self-events are ignored (the
        reference skips the local node in its informer handlers)."""
        if name == self._node_name:
            return
        nr = NodeRoute(name=name, node_ip=node_ip, pod_cidr=pod_cidr)
        if self._nodes.get(name) == nr:
            return
        self._commit(nodes={**self._nodes, name: nr})

    def delete_node(self, name: str) -> None:
        if name in self._nodes:
            nodes = dict(self._nodes)
            del nodes[name]
            self._commit(nodes=nodes)

    # -- local pod lifecycle (fed by the CNI server / interface store) ------

    def pod_added(self, ip: str, ofport: int) -> None:
        if self._pods.get(ip) == ofport:
            return
        self._commit(pods={**self._pods, ip: ofport})

    def pod_deleted(self, ip: str) -> None:
        if ip in self._pods:
            pods = dict(self._pods)
            del pods[ip]
            self._commit(pods=pods)

    def sync_interfaces(self, ifaces) -> None:
        """Bulk-load from an InterfaceStore (restart recovery: the
        reference rebuilds pod flows from the interface store on boot,
        agent.go:279)."""
        self._commit(pods={ic.ip: ic.ofport for ic in ifaces})

    # -- TrafficControl rules (ref trafficcontrol controller) ----------------

    def upsert_tc_rule(self, rule: TrafficControlRule) -> None:
        if self._tc.get(rule.name) == rule:
            return
        self._commit(tc={**self._tc, rule.name: rule})

    def delete_tc_rule(self, name: str) -> None:
        if name in self._tc:
            tc = dict(self._tc)
            del tc[name]
            self._commit(tc=tc)

    # -- multicast groups (owned by MulticastController) ---------------------

    def set_mcast_groups(self, groups: list) -> None:
        prev = self._mcast
        self._mcast = list(groups)
        try:
            self._dp.install_topology(self.topology)
        except Exception:
            self._mcast = prev
            raise

    # -- state ---------------------------------------------------------------

    @property
    def topology(self) -> Topology:
        return Topology(
            node_name=self._node_name,
            gateway_ip=self._gateway_ip,
            pod_cidr=self._pod_cidr,
            local_pods=sorted(self._pods.items()),
            remote_nodes=[self._nodes[k] for k in sorted(self._nodes)],
            tc_rules=[self._tc[k] for k in sorted(self._tc)],
            mcast_groups=list(self._mcast),
        )

    def node_route(self, name: str) -> Optional[NodeRoute]:
        return self._nodes.get(name)

    def _commit(self, nodes=None, pods=None, tc=None) -> None:
        """Install-then-commit: the candidate topology is installed first
        (install_topology compiles before swapping, raising on invalid
        input without touching datapath state), and the controller's maps
        advance only on success — one bad event (overlapping podCIDRs, a
        reused ofport) reports its error without poisoning later
        reconciles, the workqueue-retry discipline of the reference."""
        prev = (self._nodes, self._pods, self._tc)
        self._nodes = nodes if nodes is not None else self._nodes
        self._pods = pods if pods is not None else self._pods
        self._tc = tc if tc is not None else self._tc
        try:
            self._dp.install_topology(self.topology)
        except Exception:
            self._nodes, self._pods, self._tc = prev
            raise
