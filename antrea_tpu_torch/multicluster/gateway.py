"""Multicluster Gateway: election, ClusterInfo exchange, datapath routes.

The member-side Gateway path of the reference
(multicluster/controllers/multicluster/member/
gateway_controller.go:57,:80 — the Gateway CR is exported as a ClusterInfo
ResourceExport to the leader; clusterinfo imports of OTHER clusters come
back and pkg/agent/multicluster programs the routes):

  * each member cluster elects ONE gateway node among its agents
    (agent/memberlist consistent hash — the same failover machinery the
    Egress controller uses, so a dead gateway re-elects automatically);
  * the member exports {cluster id, gateway node+IP, pod CIDRs} as
    ClusterInfo; the leader fans every member's ClusterInfo out to every
    OTHER member (clusterinfo_controller.go semantics);
  * each member turns the imported remote ClusterInfos into datapath
    routes (mc_node_routes): on the GATEWAY node, remote-cluster pod
    CIDRs tunnel to the REMOTE gateway IP; on every other node they
    tunnel to the LOCAL gateway (the two-hop cross-cluster path,
    pkg/agent/multicluster/mc_route_controller.go).

Routes are ordinary compiler/topology.NodeRoute entries, so the existing
full-walk kernel forwards cross-cluster traffic (FWD_TUNNEL + peer ip)
with policy applied — no special MC tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..agent.memberlist import MemberlistCluster
from ..compiler.topology import NodeRoute


@dataclass(frozen=True)
class ClusterInfo:
    """The ClusterInfo ResourceExport payload (ref mcv1alpha1 ClusterInfo:
    clusterID, gateway infos, podCIDRs/serviceCIDR)."""

    cluster_id: str
    gateway_node: str
    gateway_ip: str  # the address peers tunnel to (GatewayIP)
    pod_cidrs: tuple = ()
    service_cidr: str = ""


class GatewayController:
    """Member-side gateway election + route computation for one cluster.

    Wraps a MemberlistCluster of this member's agent nodes: the consistent
    hash owner of the cluster-id key IS the gateway (deterministic across
    every node's independent computation, and it fails over with
    membership — gateway_controller.go's active-gateway semantics without
    a leader write).
    """

    GATEWAY_KEY = "mc-gateway"

    def __init__(self, cluster_id: str, node_ips: dict):
        """node_ips: {node name: node IP} of this member's agents."""
        self.cluster_id = cluster_id
        self._node_ips = dict(node_ips)
        self._ml = MemberlistCluster(next(iter(node_ips)))
        for n in list(node_ips)[1:]:
            self._ml.join(n)
        # Remote ClusterInfos by cluster id (the member's import cache).
        self._remote: dict[str, ClusterInfo] = {}

    # -- membership / election ----------------------------------------------

    def node_failed(self, node: str) -> None:
        self._ml.leave(node)

    def node_joined(self, node: str, node_ip: str) -> None:
        self._node_ips[node] = node_ip
        self._ml.join(node)

    @property
    def gateway_node(self) -> str:
        gw = self._ml.owner_of(self.GATEWAY_KEY)
        if gw is None:
            raise RuntimeError(
                f"cluster {self.cluster_id}: no live node to elect a gateway"
            )
        return gw

    def cluster_info(self, pod_cidrs, service_cidr: str = "") -> ClusterInfo:
        """This member's ClusterInfo export (the gateway_controller.go
        createResourceExport payload)."""
        gw = self.gateway_node
        return ClusterInfo(
            cluster_id=self.cluster_id,
            gateway_node=gw,
            gateway_ip=self._node_ips[gw],
            pod_cidrs=tuple(pod_cidrs),
            service_cidr=service_cidr,
        )

    # -- imports -> routes ----------------------------------------------------

    def apply_cluster_info(self, info: ClusterInfo) -> None:
        """Import a REMOTE cluster's ClusterInfo (leader fan-out)."""
        if info.cluster_id == self.cluster_id:
            return  # own export reflected back: ignore (ref skips self)
        self._remote[info.cluster_id] = info

    def retract_cluster_info(self, cluster_id: str) -> None:
        self._remote.pop(cluster_id, None)

    def mc_node_routes(self, node: str) -> list:
        """NodeRoute entries THIS node must install for cross-cluster
        reachability (merged into its Topology.remote_nodes by the caller,
        like any noderoute output):

          gateway node  -> remote pod CIDRs via the remote GATEWAY IP
          other nodes   -> remote pod CIDRs via the LOCAL gateway IP
        """
        gw = self.gateway_node
        local_gw_ip = self._node_ips[gw]
        out = []
        for info in sorted(self._remote.values(), key=lambda i: i.cluster_id):
            peer = info.gateway_ip if node == gw else local_gw_ip
            for i, cidr in enumerate(info.pod_cidrs):
                out.append(NodeRoute(
                    name=f"mc-{info.cluster_id}-{i}",
                    node_ip=peer,
                    pod_cidr=cidr,
                ))
        return out


@dataclass
class ClusterInfoExchange:
    """Leader-side ClusterInfo fan-out (ref leader clusterinfo import
    handling): members publish, every OTHER member receives."""

    _infos: dict = field(default_factory=dict)  # cluster id -> ClusterInfo
    _members: dict = field(default_factory=dict)  # cluster id -> GatewayController

    def register(self, gc: GatewayController) -> None:
        self._members[gc.cluster_id] = gc
        # Late joiner receives every existing remote info.
        for info in self._infos.values():
            gc.apply_cluster_info(info)

    def publish(self, info: ClusterInfo) -> None:
        self._infos[info.cluster_id] = info
        for cid, gc in self._members.items():
            if cid != info.cluster_id:
                gc.apply_cluster_info(info)

    def withdraw(self, cluster_id: str) -> None:
        self._infos.pop(cluster_id, None)
        for cid, gc in self._members.items():
            if cid != cluster_id:
                gc.retract_cluster_info(cluster_id)
