"""Host route/iptables program renderer (the route client's rule set).

The analog of pkg/agent/route (6,331 LoC, route_linux.go +
util/iptables + util/ipset): the agent programs the HOST network stack —
routes to remote pod CIDRs via antrea-gw0, the ANTREA-POSTROUTING
masquerade chain, ipset members for pod CIDRs/NodePort addresses, and NPL
DNAT rules.  None of that is per-packet TPU work (SURVEY §2.5 places it
out of the hot path), but the RULE SET the agent derives from cluster
state is product logic — so this module renders it deterministically from
the same inputs (topology, egress table, NPL mappings, service config) as
an ordered textual program, the exact shape `iptables-restore` / `ip
route replace` batches take.  A host executor (or a test) consumes it;
diffing rendered programs is how the reference's route tests work too
(pkg/agent/route/route_linux_test.go golden expectations)."""

from __future__ import annotations

GW_DEV = "antrea-gw0"  # ref config.HostGateway default device name


def render_routes(topo) -> list[str]:
    """`ip route` program for remote pod CIDRs (route_linux.go addRoutes:
    one onlink route per remote Node via the gateway device)."""
    out = []
    for nr in sorted(topo.remote_nodes, key=lambda n: n.pod_cidr):
        out.append(
            f"ip route replace {nr.pod_cidr} via {nr.node_ip} "
            f"dev {GW_DEV} onlink"
        )
    return out


def render_ipsets(topo, node_ips=()) -> list[str]:
    """ipset membership program (util/ipset): the local pod CIDR set used
    by the masquerade rule, and the NodePort address set."""
    out = []
    if topo.pod_cidr:
        out.append(f"ipset add ANTREA-POD-IP-NET {topo.pod_cidr}")
    for ip in sorted(node_ips):
        out.append(f"ipset add ANTREA-NODEPORT-IP {ip}")
    return out


def render_snat_rules(egress_assignments, topo) -> list[str]:
    """ANTREA-POSTROUTING program (route_linux.go + egress SNAT marks):
    per-Egress SNAT rules for owned IPs, then the default masquerade for
    pod-to-external traffic."""
    out = []
    for pod_ip, egress_ip, name in egress_assignments:
        out.append(
            f"iptables -t nat -A ANTREA-POSTROUTING -s {pod_ip}/32 "
            f"-m comment --comment egress/{name} -j SNAT --to {egress_ip}"
        )
    if topo.pod_cidr:
        out.append(
            f"iptables -t nat -A ANTREA-POSTROUTING -s {topo.pod_cidr} "
            f"! -o {GW_DEV} -j MASQUERADE"
        )
    return out


def render_npl_rules(npl_mappings, node_ips) -> list[str]:
    """NodePortLocal DNAT program (pkg/agent/nodeportlocal/rules:
    iptables DNAT per mapping in the ANTREA-NODE-PORT-LOCAL chain)."""
    proto_name = {6: "tcp", 17: "udp", 132: "sctp"}
    out = []
    for (pod_ip, proto, pod_port), npl_port in sorted(
        npl_mappings.items(), key=lambda kv: kv[1]
    ):
        p = proto_name.get(proto, str(proto))
        for nip in sorted(node_ips):
            out.append(
                f"iptables -t nat -A ANTREA-NODE-PORT-LOCAL -d {nip}/32 "
                f"-p {p} --dport {npl_port} "
                f"-j DNAT --to-destination {pod_ip}:{pod_port}"
            )
    return out


def render_program(topo, *, node_ips=(), egress_assignments=(),
                   npl_mappings=None) -> list[str]:
    """The full ordered host program — what one sync of the reference's
    route client + NPL rules installer realizes.  Deterministic for a
    given input state (idempotent re-sync renders byte-identical output,
    the route client's reconcile property)."""
    return (
        render_routes(topo)
        + render_ipsets(topo, node_ips)
        + render_snat_rules(list(egress_assignments), topo)
        + render_npl_rules(npl_mappings or {}, node_ips)
    )
