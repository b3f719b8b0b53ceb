"""Secondary networks: VLAN-tagged additional pod interfaces.

The analog of pkg/agent/secondarynetwork (2,247 LoC): pods
request extra interfaces via the NetworkAttachmentDefinition annotation
(`k8s.v1.cni.cncf.io/networks`); the agent's secondary-network controller
creates a second interface per attachment on a VLAN sub-bridge with its own
IPAM (secondarynetwork/podwatch + cniserver secondary path).

Here: a `NetworkAttachment` declares (vlan, cidr); the controller allocates
from the attachment's own HostLocalIPAM, records the secondary interface in
the shared interface-store (persisted, so restart recovery re-claims it
like primary interfaces), and assigns ofports from a separate high range so
SpoofGuard and forwarding can tell primary from secondary ports.  Secondary
interfaces deliberately do NOT join the primary forwarding topology —
matching the reference, where secondary networks are isolated from the
cluster overlay (no policy, no services, VLAN-switched only); the VLAN tag
rides the interface record for the Output stage."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

from .cni import HostLocalIPAM, IPAMError

# Secondary ofports live in their own range so they never collide with
# primary pod ports (the reference separates secondary bridge ports).
FIRST_SECONDARY_OFPORT = 10_000

_IFACE_PREFIX = "secif/"
_NET_PREFIX = "secnet/"


@dataclass(frozen=True)
class NetworkAttachment:
    """NetworkAttachmentDefinition subset: a named VLAN network."""

    name: str
    vlan: int
    cidr: str


@dataclass
class SecondaryInterface:
    container_id: str
    network: str
    ip: str
    vlan: int
    ofport: int


class SecondaryNetworkController:
    def __init__(self, store=None):
        self._store = store
        self._networks: dict[str, NetworkAttachment] = {}
        self._ipam: dict[str, HostLocalIPAM] = {}
        self._ifaces: dict[tuple[str, str], SecondaryInterface] = {}
        self._next_ofport = FIRST_SECONDARY_OFPORT
        if store is not None:
            # Network DEFINITIONS persist too, so the redefinition guard in
            # upsert_network holds across restarts (a restarted agent must
            # not accept a changed vlan/cidr for a network that still has
            # persisted interfaces on the old definition).
            for key in store.keys():
                if key.startswith(_NET_PREFIX):
                    d = json.loads(store.get(key))
                    self._networks[d["name"]] = NetworkAttachment(**d)
            for key in store.keys():
                if not key.startswith(_IFACE_PREFIX):
                    continue
                d = json.loads(store.get(key))
                si = SecondaryInterface(**d)
                self._ifaces[(si.container_id, si.network)] = si
                self._next_ofport = max(self._next_ofport, si.ofport + 1)
            for name in self._networks:
                self._ensure_ipam(name)

    def upsert_network(self, na: NetworkAttachment) -> None:
        if na.name in self._networks and self._networks[na.name] != na:
            raise ValueError(
                f"network {na.name} redefinition with live config"
            )
        self._networks[na.name] = na
        if self._store is not None:
            self._store.set(
                _NET_PREFIX + na.name,
                json.dumps(dataclasses.asdict(na)).encode(),
            )
            self._store.commit()
        self._ensure_ipam(na.name)

    def _ensure_ipam(self, name: str) -> None:
        na = self._networks[name]
        if na.name not in self._ipam:
            ipam = HostLocalIPAM(na.cidr)
            # Restart recovery: re-claim persisted addresses.
            for (cid, net), si in self._ifaces.items():
                if net == na.name:
                    ipam.mark_used(cid, si.ip)
            self._ipam[na.name] = ipam

    def attach(self, container_id: str, network: str) -> SecondaryInterface:
        """CmdAdd for a secondary interface (cniserver secondary path)."""
        na = self._networks.get(network)
        if na is None:
            raise KeyError(f"unknown secondary network {network}")
        key = (container_id, network)
        if key in self._ifaces:
            return self._ifaces[key]  # idempotent, like CmdAdd replay
        ip = self._ipam[network].allocate(container_id)
        si = SecondaryInterface(
            container_id=container_id, network=network, ip=ip,
            vlan=na.vlan, ofport=self._next_ofport,
        )
        self._next_ofport += 1
        self._ifaces[key] = si
        self._persist(si)
        return si

    def detach(self, container_id: str, network: Optional[str] = None) -> int:
        """CmdDel: release one attachment, or all of a pod's; -> released."""
        gone = [
            k for k in self._ifaces
            if k[0] == container_id and (network is None or k[1] == network)
        ]
        for k in gone:
            si = self._ifaces.pop(k)
            try:
                self._ipam[si.network].release(container_id)
            except (KeyError, IPAMError):
                pass
            if self._store is not None:
                self._store.delete(_IFACE_PREFIX + f"{k[0]}/{k[1]}")
                self._store.commit()
        return len(gone)

    def interfaces(self, container_id: Optional[str] = None) -> list[SecondaryInterface]:
        return sorted(
            (si for k, si in self._ifaces.items()
             if container_id is None or k[0] == container_id),
            key=lambda s: (s.container_id, s.network),
        )

    def _persist(self, si: SecondaryInterface) -> None:
        if self._store is not None:
            self._store.set(
                _IFACE_PREFIX + f"{si.container_id}/{si.network}",
                json.dumps(dataclasses.asdict(si)).encode(),
            )
            self._store.commit()
