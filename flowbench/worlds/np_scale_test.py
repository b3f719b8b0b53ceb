"""A world of the shape of Antrea's NetworkPolicy controller scale tests
(pkg/controller/networkpolicy/networkpolicy_controller_perf_test.go):
`namespaces` Namespaces of `pods_per_namespace` Pods each, every Namespace
holding the configuration's K8s NetworkPolicies, the Pods spread evenly
over `nodes` Nodes.  The program gets what Antrea's controller sends one
node's agent, the policy span of that node: every policy that applies to
one of its Pods, its appliedTo group cut to the node's own members, its
address groups whole.

The configuration's `cluster` and `policies` keys:

- `cluster`: namespaces, pods_per_namespace, pod_labels (Pod j of a
  Namespace carries pod_labels[j % len]), nodes, node (the agent's), and
  world_seed (the scheduler's spread: a shuffle of all Pods dealt round
  robin over the Nodes).
- `policies`: per Namespace, [{name, count, select, from, ports}]: `count`
  policies that isolate the Namespace's Pods labelled `select` for ingress
  and allow ingress from its Pods labelled `from`, on ports
  [[protocol, port], ...] (none: every port).

Node n's pod CIDR is 10.<n // 256>.<n % 256>.0/24, its Pods at .2 up,
its address 192.168.<n // 256>.<n % 256>; the agent's node forwards to
every other Node's CIDR through the tunnel."""

from __future__ import annotations

import ipaddress

import numpy as np

from antrea_tpu_torch.apis import controlplane as cp
from antrea_tpu_torch.compiler.ir import PolicySet
from antrea_tpu_torch.compiler.topology import NodeRoute, Topology


def u32_to_ip(v: int) -> str:
    return str(ipaddress.IPv4Address(v & 0xFFFFFFFF))


def _pod_ip(node: int, slot: int) -> int:
    return (10 << 24) | ((node // 256) << 16) | ((node % 256) << 8) | (slot + 2)


def build(config: dict):
    """-> (PolicySet, Services, Topology, pod addresses (u32) of the whole
    cluster, the agent's node's pod addresses (u32) in ofport order)."""
    c = config["cluster"]
    n_ns, per_ns, n_nodes = c["namespaces"], c["pods_per_namespace"], c["nodes"]
    labels, me = c["pod_labels"], c["node"]
    n_pods = n_ns * per_ns
    if -(-n_pods // n_nodes) > 253:
        raise ValueError("more Pods on a Node than its /24 holds")
    rng = np.random.default_rng(c["world_seed"])
    pos = np.empty(n_pods, np.int64)
    pos[rng.permutation(n_pods)] = np.arange(n_pods)
    node_of, slot_of = pos % n_nodes, pos // n_nodes
    ips = ((10 << 24) | ((node_of // 256) << 16) | ((node_of % 256) << 8)
           | (slot_of + 2)).astype(np.uint32)
    mine = np.nonzero(node_of == me)[0]
    mine = mine[np.argsort(slot_of[mine])]
    node = f"node-{me}"

    def member(p: int) -> cp.GroupMember:
        ns, j = divmod(int(p), per_ns)
        return cp.GroupMember(ip=u32_to_ip(int(ips[p])),
                              node=f"node-{int(node_of[p])}",
                              pod_namespace=f"ns-{ns}", pod_name=f"pod-{j}")

    ps = PolicySet()
    by_ns: dict = {}
    for p in mine:
        by_ns.setdefault(int(p) // per_ns, []).append(int(p))
    for ns in sorted(by_ns):
        name = f"ns-{ns}"
        pods = range(ns * per_ns, (ns + 1) * per_ns)
        for spec in config["policies"]:
            local = [p for p in by_ns[ns]
                     if labels[p % per_ns % len(labels)] == spec["select"]]
            if not local:
                continue
            atg = f"{name}/{spec['select']}/{node}"
            ag = f"{name}/{spec['from']}"
            if atg not in ps.applied_to_groups:
                ps.applied_to_groups[atg] = cp.AppliedToGroup(
                    name=atg, members=[member(p) for p in local])
            if ag not in ps.address_groups:
                ps.address_groups[ag] = cp.AddressGroup(name=ag, members=[
                    member(p) for p in pods
                    if labels[p % per_ns % len(labels)] == spec["from"]])
            services = [cp.Service(protocol=pr, port=pt)
                        for pr, pt in spec["ports"]]
            for k in range(spec["count"]):
                uid = f"{name}/{spec['name']}" + (f"-{k}" if spec["count"] > 1
                                                   else "")
                ps.policies.append(cp.NetworkPolicy(
                    uid=uid, name=uid.split("/")[1], namespace=name,
                    type=cp.NetworkPolicyType.K8S,
                    rules=[cp.NetworkPolicyRule(
                        direction=cp.Direction.IN,
                        from_peer=cp.NetworkPolicyPeer(address_groups=[ag]),
                        services=list(services))],
                    applied_to_groups=[atg],
                    policy_types=[cp.Direction.IN]))
    topo = Topology(
        node_name=node, gateway_ip=u32_to_ip(_pod_ip(me, -1)),
        pod_cidr=f"{u32_to_ip(_pod_ip(me, -2))}/24",
        local_pods=[(u32_to_ip(int(ips[p])), 3 + i)
                    for i, p in enumerate(mine)],
        remote_nodes=[NodeRoute(name=f"node-{k}",
                                node_ip=f"192.168.{k // 256}.{k % 256}",
                                pod_cidr=f"{u32_to_ip(_pod_ip(k, -2))}/24")
                      for k in range(n_nodes) if k != me])
    return ps, [], topo, ips, ips[mine]
