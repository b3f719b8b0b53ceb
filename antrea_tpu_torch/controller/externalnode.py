"""ExternalNode: NetworkPolicy for non-Kubernetes VMs.

The analog of pkg/controller/externalnode (1,060 LoC) +
pkg/agent/externalnode (2,040 LoC): the ExternalNode CRD describes a VM
(interfaces with IPs, labels); the central controller materializes one
ExternalEntity per interface, and the grouping/NP machinery treats external
entities exactly like pods — an ACNP appliedTo/peer selector can match them
— while the VM's own agent enforces the policies on its uplink (the NonIP
pipeline hosts the non-IP passthrough in the reference).

Here the ExternalEntity is fed into the SAME NetworkPolicyController entity
path as pods (the reference's GroupEntityIndex is likewise shared,
pkg/controller/grouping), with the VM name as the span node — so span
dissemination delivers the VM's policies to the VM's agent, and the VM
agent is an ordinary AgentPolicyController + Datapath with no service or
topology state (policy-only enforcement)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..apis.crd import Pod


@dataclass
class ExternalNode:
    """crd v1alpha1 ExternalNode subset: named VM with interface IPs."""

    name: str
    namespace: str = "default"
    interface_ips: list = field(default_factory=list)
    labels: dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


class ExternalNodeController:
    """Central half: ExternalNode -> ExternalEntity upserts into the NP
    controller (externalnode_controller.go syncExternalNode creating
    ExternalEntities named <node>-<ip-suffix>)."""

    def __init__(self, np_controller):
        self._npc = np_controller
        self._entities: dict[str, list[str]] = {}  # en key -> entity keys

    def upsert(self, en: ExternalNode) -> list[str]:
        """-> the entity keys materialized for this VM."""
        self._remove_stale(en)
        keys = []
        for i, ip in enumerate(en.interface_ips):
            # One ExternalEntity per interface, named like the reference's
            # <externalnode-name>-<iface index> derivation.
            entity = Pod(
                namespace=en.namespace,
                name=f"{en.name}-if{i}",
                ip=ip,
                node=en.name,  # span: the VM's own agent
                labels=dict(en.labels),
            )
            self._npc.upsert_pod(entity)
            keys.append(entity.key)
        self._entities[en.key] = keys
        return keys

    def delete(self, key: str) -> int:
        gone = self._entities.pop(key, [])
        for entity_key in gone:
            self._npc.delete_pod(entity_key)
        return len(gone)

    def _remove_stale(self, en: ExternalNode) -> None:
        want = {
            f"{en.namespace}/{en.name}-if{i}"
            for i in range(len(en.interface_ips))
        }
        for entity_key in self._entities.get(en.key, []):
            if entity_key not in want:
                self._npc.delete_pod(entity_key)
