"""Egress: pod-selected SNAT IP assignment with consistent-hash failover.

The analog of the reference's Egress feature (crd Egress; central group
computation in pkg/controller/egress; agent-side SNAT-mark
flows + ownership election in pkg/agent/controller/egress/
egress_controller.go:154,189): an Egress policy selects pods (via the
shared grouping index) and names an egress IP; ALL egress-selected pods'
outbound traffic is SNATted to that IP by whichever node currently OWNS it
(consistent hash over alive agents, agent/memberlist.py) — ownership moves
when membership changes, no coordination needed.

Datapath surface: `build_egress_table` compiles the pod->egress mapping
into sorted range tensors; `egress_ip_for` answers the EgressMark/SNAT
classification (pipeline.go EgressMark table analog) for a source IP.
This runs host-side at the gateway boundary, not in the per-packet kernel
hot path — matching the reference, where SNAT happens at the node egress
point, after policy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..apis.crd import LabelSelector
from ..utils import ip as iputil
from .grouping import GroupEntityIndex, GroupSelector


@dataclass
class EgressPolicy:
    """crd Egress subset: appliedTo selector + the SNAT (egress) IP.

    egress_ip empty + external_ip_pool set = pool-allocated (crd Egress
    spec.externalIPPool; the reference's controller allocates from the
    named ExternalIPPool and writes it back to status, egress
    controller + pkg/controller/externalippool)."""

    name: str
    egress_ip: str = ""
    pod_selector: Optional[LabelSelector] = None
    ns_selector: Optional[LabelSelector] = None
    external_ip_pool: str = ""
    # EgressQoS (crd Egress spec.bandwidth; realized as an OVS METER bound
    # in the EgressQoS table, pipeline.go:114-195 + pkg/agent/controller/
    # egress meter install): 0 = unlimited.  Packets/sec here — the
    # verdict model carries no byte lengths.
    rate_pps: int = 0
    burst_pkts: int = 0  # 0 -> defaults to rate_pps


class EgressController:
    """Central computation: Egress CRDs x grouping index -> pod ip ->
    egress ip; emits change notifications for agents to rebuild tables."""

    def __init__(self, index: GroupEntityIndex, pools=None):
        self._pools = pools  # ExternalIPPoolController (optional)
        self.index = index
        self.index.add_event_handler(self._on_groups_changed)
        self._policies: dict[str, EgressPolicy] = {}
        self._groups: dict[str, str] = {}  # egress name -> group key
        self._subs: list[Callable[[], None]] = []

    def subscribe(self, fn: Callable[[], None]) -> None:
        self._subs.append(fn)

    def _notify(self) -> None:
        for fn in self._subs:
            fn()

    def upsert(self, eg: EgressPolicy) -> None:
        from dataclasses import replace

        old = self._policies.get(eg.name)
        owner = f"egress:{eg.name}"
        if eg.external_ip_pool:
            # Pool-backed egress IP (crd spec.externalIPPool): allocate
            # BEFORE touching any state so a failed allocation (unknown /
            # exhausted pool, pinned IP taken) leaves the previous version
            # intact.  A set egress_ip PINS that address in the pool — two
            # Egresses must never SNAT to the same IP.
            if self._pools is None:
                raise ValueError(
                    f"egress {eg.name}: no ExternalIPPool controller wired"
                )
            requested = eg.egress_ip or None
            if (old is not None
                    and old.external_ip_pool == eg.external_ip_pool
                    and requested is not None
                    and old.egress_ip != requested):
                # Pinned-IP change within the pool: release-then-reallocate
                # with rollback (single-threaded controller).
                self._pools.release(eg.external_ip_pool, owner)
                try:
                    ip = self._pools.allocate(
                        eg.external_ip_pool, owner, ip=requested
                    )
                except Exception:
                    self._pools.allocate(
                        eg.external_ip_pool, owner, ip=old.egress_ip
                    )
                    raise
            else:
                ip = self._pools.allocate(
                    eg.external_ip_pool, owner, ip=requested
                )
            eg = replace(eg, egress_ip=ip)
        elif not eg.egress_ip:
            raise ValueError(
                f"egress {eg.name}: needs egress_ip or external_ip_pool"
            )
        # A previous version's allocation in a DIFFERENT (or dropped) pool
        # is stale now — release it, or the pool leaks forever.
        if (old is not None and old.external_ip_pool
                and old.external_ip_pool != eg.external_ip_pool
                and self._pools is not None):
            self._pools.release(old.external_ip_pool, owner)
        sel = GroupSelector(namespace="", pod_selector=eg.pod_selector,
                            ns_selector=eg.ns_selector)
        new_key = self.index.add_group(sel, owner="egress")
        old_key = self._groups.get(eg.name)
        self._policies[eg.name] = eg
        self._groups[eg.name] = new_key
        if old_key is not None and old_key != new_key:
            self._gc_group(old_key)  # selector changed: drop the old group
        self._notify()

    def delete(self, name: str) -> None:
        eg = self._policies.pop(name, None)
        if (eg is not None and eg.external_ip_pool and self._pools is not None):
            self._pools.release(eg.external_ip_pool, f"egress:{name}")
        key = self._groups.pop(name, None)
        if key is not None:
            self._gc_group(key)
        self._notify()

    def _gc_group(self, key: str) -> None:
        if key not in self._groups.values():
            self.index.delete_group(key, owner="egress")

    def _on_groups_changed(self, changed: set) -> None:
        if changed & set(self._groups.values()):
            self._notify()

    def assignments(self) -> list[tuple[str, str, str]]:
        """-> sorted [(pod_ip, egress_ip, egress_name)]; first matching
        Egress by name wins for multi-selected pods (deterministic —
        upstream leaves this unspecified; the reference picks one)."""
        out: dict[str, tuple[str, str]] = {}
        for name in sorted(self._policies):
            eg = self._policies[name]
            for pod in self.index.get_members(self._groups[name]):
                if pod.ip and pod.ip not in out:
                    out[pod.ip] = (eg.egress_ip, name)
        return sorted((ip, e, n) for ip, (e, n) in out.items())

    def qos_limits(self) -> dict:
        """egress name -> (rate_pps, burst) for rate-limited Egresses (the
        meter set the agent binds in the EgressQoS table)."""
        return {
            name: (eg.rate_pps, eg.burst_pkts or eg.rate_pps)
            for name, eg in self._policies.items()
            if eg.rate_pps > 0
        }


@dataclass
class EgressTable:
    """Compiled pod->egress mapping (sorted u32 pod IPs + egress ids)."""

    pod_ips: np.ndarray  # (N,) sorted u32
    egress_idx: np.ndarray  # (N,) i32 into egress_ips
    egress_ips: list  # [str]
    names: list = field(default_factory=list)

    def egress_ip_for(self, src_ip_u32: int) -> Optional[str]:
        """EgressMark classification: the SNAT IP for a source pod, or
        None (not egress-selected -> node default SNAT / no SNAT)."""
        i = int(np.searchsorted(self.pod_ips, np.uint32(src_ip_u32)))
        if i < len(self.pod_ips) and int(self.pod_ips[i]) == src_ip_u32:
            return self.egress_ips[int(self.egress_idx[i])]
        return None

    def egress_name_for(self, src_ip_u32: int) -> Optional[str]:
        i = int(np.searchsorted(self.pod_ips, np.uint32(src_ip_u32)))
        if i < len(self.pod_ips) and int(self.pod_ips[i]) == src_ip_u32:
            return self.names[i]
        return None


class EgressQoSMeters:
    """Per-Egress token-bucket meters — the EgressQoS/OVS-meter analog
    (ref pipeline.go EgressQoS table; the reference binds one OVS meter
    per rate-limited Egress and the meter drops over-rate packets at the
    egress boundary).  Enforced host-side at the same boundary where this
    build applies SNAT (agent/route.py) — the per-packet kernel never
    carries byte budgets, matching the reference where metering lives in
    OVS, not the Go agent."""

    def __init__(self, limits: dict):
        # name -> (rate_pps, burst)
        self._limits = dict(limits)
        self._tokens = {n: float(b) for n, (_r, b) in limits.items()}
        self._last = {n: 0 for n in limits}
        self.dropped: dict = {n: 0 for n in limits}

    def admit(self, egress_name: Optional[str], n_packets: int, now: int) -> int:
        """-> packets admitted (the rest are meter drops).  Unmetered
        egresses (or None) admit everything."""
        lim = self._limits.get(egress_name)
        if lim is None:
            return n_packets
        rate, burst = lim
        t = min(burst, self._tokens[egress_name]
                + (now - self._last[egress_name]) * rate)
        self._last[egress_name] = now
        admitted = min(n_packets, int(t))
        self._tokens[egress_name] = t - admitted
        self.dropped[egress_name] += n_packets - admitted
        return admitted


def build_egress_table(assignments: list[tuple[str, str, str]]) -> EgressTable:
    ips = sorted(set(e for _, e, _ in assignments))
    eidx = {e: i for i, e in enumerate(ips)}
    pods = np.array([iputil.ip_to_u32(p) for p, _, _ in assignments], np.uint32)
    idx = np.array([eidx[e] for _, e, _ in assignments], np.int32)
    all_names = [n for _, _, n in assignments]
    order = np.argsort(pods)
    return EgressTable(
        pod_ips=pods[order], egress_idx=idx[order], egress_ips=ips,
        names=[all_names[int(i)] for i in order],  # parallel to pod_ips
    )
