"""A cell's world, made from its configuration file: the PolicySet, the
Services and the agent's node topology as the program takes them, and the
same inputs as plain data for the reference (flowbench/reference/) and the
traffic generator (flowbench/stream.py).  The reference reads nothing of
the program; the generator reads nothing of it but, in a mix with Service
connections, the endpoint the program reported for each one's first
packet (its code, dnat_ip and dnat_port), which its replies come from.

A configuration names its world's shape by `world`: the module
flowbench/worlds/<world>.py, whose build(config) returns the inputs.  A
configuration of a new shape adds such a file; the configuration's
`world_seed` fixes the world, and the run's seed draws the traffic."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


def sub_seed(seed: int, what: str) -> int:
    """A seed of its own for each part of a run, from the run's seed (any
    whole number, negative or past 64 bits included)."""
    words = list(what.encode())
    s = int(seed)
    ent = [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, (s >> 64) & 0xFFFFFFFF,
           1 if s < 0 else 0, *words]
    return int(np.random.SeedSequence(ent).generate_state(1, np.uint64)[0])


@dataclass
class World:
    config: dict
    ps: object            # antrea_tpu_torch PolicySet
    services: list        # [ServiceEntry]
    topology: object      # antrea_tpu_torch Topology
    pod_ips: np.ndarray   # u32, every Pod of the cluster
    local_ips: np.ndarray  # u32, the agent's node's Pods in ofport order


def load_config(path) -> dict:
    return json.loads(Path(path).read_text())


def build_world(config: dict) -> World:
    kind = config["world"]
    if not kind.isidentifier():
        raise ValueError(f"bad world name {kind!r}")
    mod = importlib.import_module(f"flowbench.worlds.{kind}")
    ps, services, topo, pods, local = mod.build(config)
    return World(config, ps, services, topo, np.asarray(pods, np.uint32),
                 np.asarray(local, np.uint32))


# ---- the same inputs as plain data --------------------------------------

def plain_policy(ps) -> dict:
    """A PolicySet as plain data: names, address strings, numbers."""
    def peer(p):
        return {"groups": list(p.address_groups),
                "blocks": [[b.cidr, list(b.excepts)] for b in p.ip_blocks],
                "to_services": len(p.to_services)}

    def svc(s):
        return {"proto": s.protocol, "port": s.port, "end_port": s.end_port,
                "port_name": s.port_name, "icmp_type": s.icmp_type,
                "icmp_code": s.icmp_code}

    pols = []
    for p in ps.policies:
        rules = []
        for r in p.rules:
            d = r.direction.value
            rules.append({
                "direction": d, "action": r.action.value,
                "priority": r.priority,
                "applied_to": list(r.applied_to_groups),
                "peer": peer(r.from_peer if d == "In" else r.to_peer),
                "services": [svc(s) for s in r.services],
                "l7": len(r.l7_protocols)})
        pols.append({
            "uid": p.uid, "k8s": p.type.value == "K8sNetworkPolicy",
            "tier": p.tier_priority, "priority": p.priority,
            "policy_types": [d.value for d in p.policy_types],
            "applied_to": list(p.applied_to_groups), "rules": rules})
    return {
        "address_groups": {
            n: {"ips": [m.ip for m in g.members],
                "blocks": [[b.cidr, list(b.excepts)] for b in g.ip_blocks]}
            for n, g in ps.address_groups.items()},
        "applied_to_groups": {n: [m.ip for m in g.members]
                              for n, g in ps.applied_to_groups.items()},
        "policies": pols,
    }


def plain_services(services) -> list:
    return [{"ip": s.cluster_ip, "port": s.port, "proto": s.protocol,
             "endpoints": [[e.ip, e.port] for e in s.endpoints],
             "affinity_s": s.affinity_timeout_s,
             "external": len(s.external_ips) + int(s.node_port > 0)
             + int(bool(s.dsr))}
            for s in services]


def plain_topology(topo) -> dict:
    return {"local_pods": [[ip, port] for ip, port in topo.local_pods],
            "remote_nodes": [[n.pod_cidr, n.node_ip]
                             for n in topo.remote_nodes],
            "pod_cidr": topo.pod_cidr,
            "extra": (len(topo.tc_rules) + len(topo.mcast_groups)
                      + int(bool(topo.gateway_ip6 or topo.pod_cidr6)))}


def plain_world(world: World) -> dict:
    return {"policy": plain_policy(world.ps),
            "services": plain_services(world.services),
            "topology": plain_topology(world.topology),
            "pod_ips": world.pod_ips, "local_ips": world.local_ips,
            "engine": dict(world.config["engine"])}
