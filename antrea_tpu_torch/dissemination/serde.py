"""Wire serialization for the control-plane API types.

The analog of the reference's protobuf codecs for the controlplane API
group (pkg/apis/controlplane — versioned v1beta2 objects,
serialized protobuf over the watch connection, architecture.md:63-64).
JSON is the wire format here — the schema discipline is the same: explicit
field maps per type, a version tag, and round-trip tests.  Everything that
crosses a process boundary (dissemination transport) or survives a restart
(datapath snapshots, agent filestore) goes through these functions.
"""

from __future__ import annotations

import json

from ..apis import controlplane as cp
from ..apis.service import Endpoint, ServiceEntry
from ..compiler.ir import PolicySet
from ..controller.networkpolicy import WatchEvent

WIRE_VERSION = 1


# -- controlplane objects ----------------------------------------------------


def _member(m: cp.GroupMember) -> dict:
    out = {"ip": m.ip, "node": m.node, "ns": m.pod_namespace, "pod": m.pod_name}
    if m.ports:
        # Named ports (types.go:87-88): [[name, port, protocol], ...]
        out["ports"] = [list(t) for t in m.ports]
    return out


def _member_from(d: dict) -> cp.GroupMember:
    return cp.GroupMember(
        ip=d["ip"], node=d.get("node", ""),
        pod_namespace=d.get("ns", ""), pod_name=d.get("pod", ""),
        ports=tuple(
            (str(n), int(pt), int(pr)) for n, pt, pr in d.get("ports", ())
        ),
    )


def _block(b: cp.IPBlock) -> dict:
    return {"cidr": b.cidr, "except": list(b.excepts)}


def _block_from(d: dict) -> cp.IPBlock:
    return cp.IPBlock(cidr=d["cidr"], excepts=tuple(d.get("except", ())))


def _peer(p: cp.NetworkPolicyPeer) -> dict:
    out = {
        "addressGroups": list(p.address_groups),
        "ipBlocks": [_block(b) for b in p.ip_blocks],
    }
    if p.to_services:
        # controlplane ServiceReference list (types.go ToServices wire form).
        out["toServices"] = [
            {"name": sr.name, "namespace": sr.namespace}
            for sr in p.to_services
        ]
    return out


def _peer_from(d: dict) -> cp.NetworkPolicyPeer:
    return cp.NetworkPolicyPeer(
        address_groups=list(d.get("addressGroups", ())),
        ip_blocks=[_block_from(b) for b in d.get("ipBlocks", ())],
        to_services=[
            cp.ServiceReference(name=sr["name"],
                                namespace=sr.get("namespace", "default"))
            for sr in d.get("toServices", ())
        ],
    )


def _service(s: cp.Service) -> dict:
    out = {"protocol": s.protocol, "port": s.port, "endPort": s.end_port}
    if s.port_name:
        out["portName"] = s.port_name  # IntOrString string form
    if s.icmp_type is not None:
        out["icmpType"] = s.icmp_type  # types.go:311 ICMPType/ICMPCode
        if s.icmp_code is not None:
            out["icmpCode"] = s.icmp_code
    return out


def _service_from(d: dict) -> cp.Service:
    return cp.Service(
        protocol=d.get("protocol"), port=d.get("port"),
        end_port=d.get("endPort"), port_name=d.get("portName", ""),
        icmp_type=d.get("icmpType"), icmp_code=d.get("icmpCode"),
    )


def _rule(r: cp.NetworkPolicyRule) -> dict:
    return {
        "direction": r.direction.value,
        "from": _peer(r.from_peer),
        "to": _peer(r.to_peer),
        "services": [_service(s) for s in r.services],
        "action": r.action.value,
        "priority": r.priority,
        "name": r.name,
        "appliedToGroups": list(r.applied_to_groups),
        "l7Protocols": list(r.l7_protocols),
    }


def _rule_from(d: dict) -> cp.NetworkPolicyRule:
    return cp.NetworkPolicyRule(
        direction=cp.Direction(d["direction"]),
        from_peer=_peer_from(d.get("from", {})),
        to_peer=_peer_from(d.get("to", {})),
        services=[_service_from(s) for s in d.get("services", ())],
        action=cp.RuleAction(d.get("action", "Allow")),
        priority=d.get("priority", -1),
        name=d.get("name", ""),
        applied_to_groups=list(d.get("appliedToGroups", ())),
        l7_protocols=list(d.get("l7Protocols", ())),
    )


def encode_policy(p: cp.NetworkPolicy) -> dict:
    return {
        "uid": p.uid,
        "name": p.name,
        "namespace": p.namespace,
        "type": p.type.value,
        "rules": [_rule(r) for r in p.rules],
        "appliedToGroups": list(p.applied_to_groups),
        "policyTypes": [d.value for d in p.policy_types],
        "tierPriority": p.tier_priority,
        "priority": p.priority,
        "generation": p.generation,
    }


def decode_policy(d: dict) -> cp.NetworkPolicy:
    return cp.NetworkPolicy(
        uid=d["uid"],
        name=d.get("name", ""),
        namespace=d.get("namespace", ""),
        type=cp.NetworkPolicyType(d.get("type", "K8sNetworkPolicy")),
        rules=[_rule_from(r) for r in d.get("rules", ())],
        applied_to_groups=list(d.get("appliedToGroups", ())),
        policy_types=[cp.Direction(x) for x in d.get("policyTypes", ())],
        tier_priority=d.get("tierPriority"),
        priority=d.get("priority"),
        generation=int(d.get("generation", 0)),
    )


def encode_address_group(g: cp.AddressGroup) -> dict:
    return {
        "name": g.name,
        "members": [_member(m) for m in g.members],
        "ipBlocks": [_block(b) for b in g.ip_blocks],
    }


def decode_address_group(d: dict) -> cp.AddressGroup:
    return cp.AddressGroup(
        name=d["name"],
        members=[_member_from(m) for m in d.get("members", ())],
        ip_blocks=[_block_from(b) for b in d.get("ipBlocks", ())],
    )


def encode_applied_to_group(g: cp.AppliedToGroup) -> dict:
    return {"name": g.name, "members": [_member(m) for m in g.members]}


def decode_applied_to_group(d: dict) -> cp.AppliedToGroup:
    return cp.AppliedToGroup(
        name=d["name"], members=[_member_from(m) for m in d.get("members", ())]
    )


_OBJ_CODECS = {
    "NetworkPolicy": (encode_policy, decode_policy),
    "AddressGroup": (encode_address_group, decode_address_group),
    "AppliedToGroup": (encode_applied_to_group, decode_applied_to_group),
}


# -- PolicySet + services (snapshot surface) ---------------------------------


def encode_policy_set(ps: PolicySet) -> dict:
    return {
        "policies": [encode_policy(p) for p in ps.policies],
        "addressGroups": {
            k: encode_address_group(g) for k, g in ps.address_groups.items()
        },
        "appliedToGroups": {
            k: encode_applied_to_group(g) for k, g in ps.applied_to_groups.items()
        },
    }


def decode_policy_set(d: dict) -> PolicySet:
    return PolicySet(
        policies=[decode_policy(p) for p in d.get("policies", ())],
        address_groups={
            k: decode_address_group(g)
            for k, g in d.get("addressGroups", {}).items()
        },
        applied_to_groups={
            k: decode_applied_to_group(g)
            for k, g in d.get("appliedToGroups", {}).items()
        },
    )


def encode_service_entry(s: ServiceEntry) -> dict:
    return {
        "clusterIP": s.cluster_ip,
        "port": s.port,
        "protocol": s.protocol,
        "endpoints": [
            {"ip": e.ip, "port": e.port, "node": e.node} for e in s.endpoints
        ],
        "affinitySeconds": s.affinity_timeout_s,
        "name": s.name,
        "namespace": s.namespace,
        "externalIPs": list(s.external_ips),
        "nodePort": s.node_port,
        "externalTrafficPolicy": s.external_traffic_policy,
        # service.antrea.io/load-balancer-mode analog: without this a
        # persisted DSR service would silently revert to regular DNAT
        # (and SNAT) after an agent restart.
        "loadBalancerModeDSR": s.dsr,
    }


def decode_service_entry(d: dict) -> ServiceEntry:
    return ServiceEntry(
        cluster_ip=d["clusterIP"],
        port=d["port"],
        protocol=d["protocol"],
        endpoints=[
            Endpoint(ip=e["ip"], port=e["port"], node=e.get("node", ""))
            for e in d.get("endpoints", ())
        ],
        affinity_timeout_s=d.get("affinitySeconds", 0),
        name=d.get("name", ""),
        namespace=d.get("namespace", ""),
        external_ips=list(d.get("externalIPs", ())),
        node_port=d.get("nodePort", 0),
        external_traffic_policy=d.get("externalTrafficPolicy", "Cluster"),
        dsr=d.get("loadBalancerModeDSR", False),
    )


# -- Topology (forwarding plane; datapath snapshots) -------------------------


def encode_topology(t) -> dict:
    return {
        "node": t.node_name,
        "gatewayIP": t.gateway_ip,
        "gatewayIPv6": t.gateway_ip6,
        "podCIDR": t.pod_cidr,
        "podCIDRv6": t.pod_cidr6,
        "localPods": [[ip, port] for ip, port in t.local_pods],
        "remoteNodes": [
            {"name": n.name, "nodeIP": n.node_ip, "podCIDR": n.pod_cidr}
            for n in t.remote_nodes
        ],
        "tcRules": [
            {"name": r.name, "podIPs": list(r.pod_ips), "action": r.action,
             "targetPort": r.target_port, "direction": r.direction}
            for r in t.tc_rules
        ],
        "mcastGroups": [
            {"group": g.group_ip, "ports": list(g.local_ports),
             "nodes": list(g.remote_nodes)}
            for g in t.mcast_groups
        ],
    }


def decode_topology(d: dict):
    from ..compiler.topology import (
        McastGroup, NodeRoute, Topology, TrafficControlRule,
    )

    return Topology(
        node_name=d.get("node", ""),
        gateway_ip=d.get("gatewayIP", ""),
        gateway_ip6=d.get("gatewayIPv6", ""),
        pod_cidr6=d.get("podCIDRv6", ""),
        pod_cidr=d.get("podCIDR", ""),
        local_pods=[(ip, port) for ip, port in d.get("localPods", ())],
        remote_nodes=[
            NodeRoute(name=n["name"], node_ip=n["nodeIP"], pod_cidr=n["podCIDR"])
            for n in d.get("remoteNodes", ())
        ],
        tc_rules=[
            TrafficControlRule(
                name=r["name"], pod_ips=tuple(r["podIPs"]), action=r["action"],
                target_port=r["targetPort"], direction=r.get("direction", "both"),
            )
            for r in d.get("tcRules", ())
        ],
        mcast_groups=[
            McastGroup(group_ip=g["group"], local_ports=tuple(g["ports"]),
                       remote_nodes=tuple(g["nodes"]))
            for g in d.get("mcastGroups", ())
        ],
    )


# -- WatchEvent (the dissemination wire unit) --------------------------------


def encode_event(ev: WatchEvent) -> dict:
    enc = _OBJ_CODECS[ev.obj_type][0] if ev.obj is not None else None
    return {
        "v": WIRE_VERSION,
        "kind": ev.kind,
        "objType": ev.obj_type,
        "name": ev.name,
        "obj": enc(ev.obj) if enc else None,
        "span": sorted(ev.span),
        "added": [_member(m) for m in ev.added],
        "removed": [_member(m) for m in ev.removed],
        "spanOnly": ev.span_only,
        # Controller-commit stamp (dissemination-latency origin); omitted
        # when unstamped so pre-existing captures stay byte-identical.
        **({"ts": ev.ts} if ev.ts else {}),
    }


def decode_event(d: dict) -> WatchEvent:
    v = d.get("v", 0)
    if v != WIRE_VERSION:
        raise ValueError(f"unsupported wire version {v}")
    obj = None
    if d.get("obj") is not None:
        obj = _OBJ_CODECS[d["objType"]][1](d["obj"])
    return WatchEvent(
        kind=d["kind"],
        obj_type=d["objType"],
        name=d["name"],
        obj=obj,
        span=set(d.get("span", ())),
        added=[_member_from(m) for m in d.get("added", ())],
        removed=[_member_from(m) for m in d.get("removed", ())],
        span_only=d.get("spanOnly", False),
        ts=d.get("ts", 0.0),
    )


def event_to_wire(ev: WatchEvent) -> bytes:
    """One length-free JSON line (newline-delimited framing)."""
    return (json.dumps(encode_event(ev), separators=(",", ":")) + "\n").encode()


def event_from_wire(line: bytes) -> WatchEvent:
    return decode_event(json.loads(line.decode()))
