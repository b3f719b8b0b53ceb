"""Multicluster core: the leader/member resource-exchange pipeline.

The semantic slice of the reference's multicluster module
(multicluster/ — a separate controller-runtime module):

  * ClusterSet (leader + members; multicluster/controllers/multicluster/
    leader/clusterset_controller.go): membership and the exchange pipeline.
  * ServiceExport -> ResourceExport -> ResourceImport conversion
    (leader/resourceexport_controller.go): a member exports a Service; the
    leader merges all clusters' exports of the same namespaced name into
    ONE ResourceImport carrying the union of endpoints.
  * Service import (member/serviceimport): each member materializes the
    import as a local multi-cluster Service (`antrea-mc-<name>`) with a
    ClusterIP from its own MC service range; its endpoints are the OTHER
    clusters' exported endpoints (reaching them rides the cross-cluster
    Geneve tunnel in the reference — here the DNAT target is simply the
    remote pod IP, which the simulator's flat address space routes).
  * ACNP replication (member/acnp replication of leader-distributed
    policies): a ClusterSet-scoped ACNP applies to every member's policy
    controller.
  * LabelIdentity (leader label-identity export + pkg/controller/
    labelidentity): normalized label strings -> cluster-set-wide numeric
    IDs, allocated once per unique label string.

Everything is synchronous in-process calls, like the central NP
controller; the dissemination plane provides the async/wire boundary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..apis.crd import AntreaNetworkPolicy
from ..apis.service import Endpoint, ServiceEntry

MC_SERVICE_PREFIX = "antrea-mc-"


@dataclass
class ResourceExport:
    """Leader-side record of one member's export (ref ResourceExport CRD)."""

    cluster: str
    namespace: str
    name: str
    service: ServiceEntry  # the exported service spec (incl. endpoints)


@dataclass
class ResourceImport:
    """Merged view the leader disseminates (ref ResourceImport CRD)."""

    namespace: str
    name: str
    port: int
    protocol: int
    # (cluster, Endpoint) pairs — unioned across exporting clusters.
    endpoints: list = field(default_factory=list)
    # Clusters whose export's port/protocol disagrees with the first
    # (cluster-id-ordered) exporter: surfaced, not merged (the reference
    # marks conflicting ResourceExports rather than guessing a winner).
    conflicts: list = field(default_factory=list)


class LabelIdentityIndex:
    """Normalized label string -> stable numeric id (ref
    pkg/controller/labelidentity + multicluster label-identity export).
    IDs are cluster-set-wide: both members resolving the same label string
    get the same id, which stretched policies can match on."""

    def __init__(self):
        self._ids: dict[str, int] = {}

    def id_of(self, namespace_labels: dict, pod_labels: dict) -> int:
        key = "ns:" + ",".join(
            f"{k}={v}" for k, v in sorted(namespace_labels.items())
        ) + ";pod:" + ",".join(f"{k}={v}" for k, v in sorted(pod_labels.items()))
        if key not in self._ids:
            self._ids[key] = len(self._ids) + 1  # 0 reserved (unknown)
        return self._ids[key]


class MemberCluster:
    """One member cluster's MC agent surface: exports local services,
    materializes imports as local Services, receives replicated ACNPs."""

    def __init__(self, cluster_id: str, mc_cidr_prefix: str = "10.96.200"):
        self.cluster_id = cluster_id
        self._mc_cidr_prefix = mc_cidr_prefix
        self._next_ip = 1
        self._free_ips: list[str] = []
        self.local_services: dict[tuple[str, str], ServiceEntry] = {}
        self.imported: dict[tuple[str, str], ServiceEntry] = {}
        self.replicated_policies: dict[str, AntreaNetworkPolicy] = {}
        self._import_ips: dict[tuple[str, str], str] = {}

    # -- member-side API ------------------------------------------------------

    def add_local_service(self, namespace: str, svc: ServiceEntry) -> None:
        self.local_services[(namespace, svc.name)] = svc

    def _alloc_mc_ip(self, key: tuple[str, str]) -> str:
        ip = self._import_ips.get(key)
        if ip is None:
            if self._free_ips:
                ip = self._free_ips.pop()  # retracted imports recycle IPs
            elif self._next_ip <= 254:
                ip = f"{self._mc_cidr_prefix}.{self._next_ip}"
                self._next_ip += 1
            else:  # /24 range: guard like other compile caps
                raise ValueError(
                    f"MC service range {self._mc_cidr_prefix}.0/24 exhausted "
                    f"(254 live imports); widen mc_cidr_prefix"
                )
            self._import_ips[key] = ip
        return ip

    def apply_import(self, ri: ResourceImport) -> Optional[ServiceEntry]:
        """Materialize a ResourceImport as the local antrea-mc-<name>
        Service.  Endpoints: every exporting cluster's endpoints EXCEPT
        this cluster's own (local traffic reaches local pods via the
        ordinary local Service; the MC service is the cross-cluster path,
        ref member/serviceimport controller)."""
        key = (ri.namespace, ri.name)
        eps = [ep for cl, ep in ri.endpoints if cl != self.cluster_id]
        svc = ServiceEntry(
            cluster_ip=self._alloc_mc_ip(key),
            port=ri.port,
            protocol=ri.protocol,
            endpoints=list(eps),
            name=f"{MC_SERVICE_PREFIX}{ri.name}",
            namespace=ri.namespace,
        )
        self.imported[key] = svc
        return svc

    def retract_import(self, namespace: str, name: str) -> None:
        self.imported.pop((namespace, name), None)
        ip = self._import_ips.pop((namespace, name), None)
        if ip is not None:
            self._free_ips.append(ip)  # the ClusterIP returns to the pool

    def apply_replicated_policy(self, anp: AntreaNetworkPolicy) -> None:
        self.replicated_policies[anp.uid] = anp

    def all_services(self) -> list[ServiceEntry]:
        """Local + imported services, the set this member's datapath
        compiles (compiler/services.py input)."""
        return list(self.local_services.values()) + sorted(
            self.imported.values(), key=lambda s: (s.namespace, s.name)
        )


class LeaderController:
    """Leader-side conversion pipeline: ResourceExports in, merged
    ResourceImports + replicated policies out to every member."""

    def __init__(self):
        self._exports: dict[tuple[str, str, str], ResourceExport] = {}
        self._members: dict[str, MemberCluster] = {}
        self._policies: dict[str, AntreaNetworkPolicy] = {}
        self.label_identities = LabelIdentityIndex()

    def join(self, member: MemberCluster) -> None:
        self._members[member.cluster_id] = member
        # Late joiners receive the current state (the reference's initial
        # ResourceImport list + ACNP resync).
        for ri in self._imports().values():
            member.apply_import(ri)
        for anp in self._policies.values():
            member.apply_replicated_policy(anp)

    def leave(self, cluster_id: str) -> None:
        self._members.pop(cluster_id, None)
        # A departed member's exports are stale: GC them (leader stale
        # controller, leader/stale_controller.go).
        gone = [k for k in self._exports if k[0] == cluster_id]
        touched = {(k[1], k[2]) for k in gone}
        for k in gone:
            del self._exports[k]
        self._reconcile(touched)

    # -- export intake --------------------------------------------------------

    def export_service(self, cluster_id: str, namespace: str,
                       svc: ServiceEntry) -> None:
        """A member's ServiceExport arrives (ref ServiceExport CRD ->
        ResourceExport conversion)."""
        self._exports[(cluster_id, namespace, svc.name)] = ResourceExport(
            cluster=cluster_id, namespace=namespace, name=svc.name, service=svc,
        )
        self._reconcile({(namespace, svc.name)})

    def retract_export(self, cluster_id: str, namespace: str, name: str) -> None:
        self._exports.pop((cluster_id, namespace, name), None)
        self._reconcile({(namespace, name)})

    # -- policy replication ---------------------------------------------------

    def replicate_policy(self, anp: AntreaNetworkPolicy) -> None:
        """Distribute a ClusterSet-scoped ACNP to every member."""
        self._policies[anp.uid] = anp
        for m in self._members.values():
            m.apply_replicated_policy(anp)

    # -- conversion -----------------------------------------------------------

    def _imports(self) -> dict[tuple[str, str], ResourceImport]:
        out: dict[tuple[str, str], ResourceImport] = {}
        # Deterministic merge order: cluster id, so the defining exporter
        # (whose port/protocol the import carries) never depends on dict
        # iteration or arrival order.
        for k in sorted(self._exports):
            ex = self._exports[k]
            key = (ex.namespace, ex.name)
            ri = out.get(key)
            if ri is None:
                ri = out[key] = ResourceImport(
                    namespace=ex.namespace, name=ex.name,
                    port=ex.service.port, protocol=ex.service.protocol,
                )
            elif (ex.service.port, ex.service.protocol) != (ri.port, ri.protocol):
                # Spec mismatch: exclude this cluster's endpoints and
                # surface the conflict instead of silently merging.
                ri.conflicts.append(ex.cluster)
                continue
            for ep in ex.service.endpoints:
                ri.endpoints.append((ex.cluster, ep))
        for ri in out.values():
            ri.endpoints.sort(key=lambda ce: (ce[0], ce[1].ip, ce[1].port))
            ri.conflicts.sort()
        return out

    def _reconcile(self, touched: set) -> None:
        imports = self._imports()
        for key in touched:
            ri = imports.get(key)
            for m in self._members.values():
                if ri is None:
                    m.retract_import(*key)
                else:
                    m.apply_import(ri)


@dataclass
class ClusterSet:
    """The ClusterSet wiring: one leader + joined members."""

    leader: LeaderController = field(default_factory=LeaderController)
    members: dict = field(default_factory=dict)

    def add_member(self, cluster_id: str) -> MemberCluster:
        m = MemberCluster(cluster_id)
        self.members[cluster_id] = m
        self.leader.join(m)
        return m

    def remove_member(self, cluster_id: str) -> None:
        """Full departure: leader GCs the member's exports AND the member
        drops its MC-materialized state (the member-side stale controller
        removes antrea-mc services / replicated policies on ClusterSet
        departure)."""
        m = self.members.pop(cluster_id, None)
        self.leader.leave(cluster_id)
        if m is not None:
            m.imported.clear()
            m.replicated_policies.clear()
