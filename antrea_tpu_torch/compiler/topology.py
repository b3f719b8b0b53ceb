"""Node topology -> forwarding tensors (the L2/L3 forwarding plane).

The reference realizes per-node forwarding as OVS tables the agent programs
from two sources:

  * the node-route controller — one tunnel/route/ARP flow set per remote
    Node (the reference's pkg/agent/controller/noderoute/node_route_controller.go),
    compiled into L3Forwarding entries "dst in remote podCIDR -> set tunnel
    dst = peer node IP, output tunnel port";
  * the CNI server / interface store — one L2ForwardingCalc entry per local
    pod "dst ip == pod ip -> output pod ofport"
    (pkg/agent/openflow/pipeline.go L2ForwardingCalc, podConfigurator);
  plus SpoofGuard (packets entering on a pod port must carry that pod's
  bound source IP, pipeline.go SpoofGuard), an ARP responder for gateway /
  remote-gateway addresses (pipeline.go ARPResponder), TrafficControl
  mirror/redirect marks (pkg/agent/controller/trafficcontrol), and L3DecTTL
  for routed legs.

Here the same decisions are compiled into sorted tensor tables consumed by
batched gathers (models/forwarding.py): a packet's output decision is two
searchsorted probes (local-pod exact match, remote-CIDR interval match) —
O(log n) per packet, no per-flow entries, and topology swaps are atomic
tensor swaps like rule bundles.  Tables are padded to power-of-two capacity
with device-resident row counts so membership churn never changes tensor
SHAPES (no XLA recompiles — same rationale as ops/match.DeltaTable).

Port number conventions follow the reference's defaults: tunnel ofport 1,
gateway ofport 2 (pkg/agent/config/node_config.go DefaultTunOFPort /
DefaultHostGatewayOFPort), pod ports from 3 up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np

from ..utils import ip as iputil

# Well-known ofports (ref pkg/agent/config/node_config.go:
# DefaultTunOFPort=1, DefaultHostGatewayOFPort=2).
OFPORT_TUNNEL = 1
OFPORT_GATEWAY = 2
FIRST_POD_OFPORT = 3

# Forwarding kinds (the Output-stage disposition, ref pipeline.go
# L2ForwardingCalc/L3Forwarding/Output tables).
FWD_LOCAL = 0  # dst is a local pod -> output its ofport
FWD_TUNNEL = 1  # dst in a remote node's podCIDR -> encap to peer, output tunnel
FWD_GATEWAY = 2  # everything else (external / host / service ext) -> gateway
FWD_DROP_SPOOF = 3  # SpoofGuard verdict: src doesn't match the ingress port
FWD_DROP_UNKNOWN = 4  # dst in the LOCAL podCIDR but no such pod -> drop
FWD_MCAST = 5  # dst is a joined multicast group -> replicate (MulticastOutput)
FWD_DROP_MCAST = 6  # multicast dst with no receivers -> drop (MulticastRouting miss)
FWD_PUNT = 7  # punted to the controller (IGMP packet-in, packetin.go:44)
FWD_ARP_REPLY = 8  # ARP request we answer (ARPResponder) -> reply out in_port
FWD_ARP_FLOOD = 9  # ARP we don't answer -> normal L2 flood (OFPP_NORMAL)

# ARP opcodes carried in PacketBatch.arp_op (0 = not ARP).
ARP_OP_REQUEST = 1
ARP_OP_REPLY = 2

# Pseudo-port for multicast replication (the consumer resolves the actual
# port list via Datapath.mcast_group(mcast_idx)).
OFPORT_REPLICATE = -2

# IGMP protocol number (membership reports/queries are punted, never
# forwarded — ref pkg/agent/multicast IGMP snooping via packet-in).
PROTO_IGMP = 2

# 224.0.0.0/4 in flipped-i32 space (iputil.flip_u32 semantics).
MCAST_LO_F = 0x60000000
MCAST_HI_F = 0x6FFFFFFF

# TrafficControl actions (ref pkg/apis/crd TrafficControl: Mirror/Redirect).
TC_NONE = 0
TC_MIRROR = 1
TC_REDIRECT = 2

_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


@dataclass(frozen=True)
class NodeRoute:
    """One remote node's route (ref noderoute controller's per-Node state:
    nodeRouteInfo — peer node IP is the tunnel destination, podCIDR the
    routed prefix)."""

    name: str
    node_ip: str
    pod_cidr: str


@dataclass(frozen=True)
class TrafficControlRule:
    """Mirror/redirect mark for a set of pods (ref TrafficControl CRD,
    pkg/agent/controller/trafficcontrol: appliedTo pods, direction
    ingress/egress/both, action mirror/redirect, target device port)."""

    name: str
    pod_ips: tuple
    action: int  # TC_MIRROR / TC_REDIRECT
    target_port: int
    direction: str = "both"  # "ingress" (to pod) / "egress" (from pod) / "both"


@dataclass(frozen=True)
class McastGroup:
    """One joined multicast group (ref pkg/agent/multicast GroupMemberStatus:
    local receiver ofports from IGMP snooping + remote nodes with interest
    for the inter-node replication leg)."""

    group_ip: str
    local_ports: tuple = ()
    remote_nodes: tuple = ()  # node names; resolved to peer IPs at replicate


@dataclass
class Topology:
    """One node's forwarding world — the input the agent-side controllers
    (CNI server + noderoute + trafficcontrol + multicast) maintain.

    Dual-stack (ref pkg/agent/route/route_linux.go programming v4 AND v6
    routes/neighbors per node): local_pods may carry v6 addresses (a
    dual-stack pod appears once per family, same ofport), remote_nodes may
    carry v6 podCIDRs (one NodeRoute per family, like the reference's
    PodCIDRs list), and gateway_ip6/pod_cidr6 are the v6 twins of the
    node's own addresses."""

    node_name: str = ""
    gateway_ip: str = ""
    gateway_ip6: str = ""  # v6 gateway ("" = none)
    pod_cidr: str = ""  # this node's local pod CIDR ("" = none)
    pod_cidr6: str = ""  # this node's local v6 pod CIDR ("" = none)
    local_pods: list = field(default_factory=list)  # [(ip_str, ofport)]
    remote_nodes: list = field(default_factory=list)  # [NodeRoute]
    tc_rules: list = field(default_factory=list)  # [TrafficControlRule]
    mcast_groups: list = field(default_factory=list)  # [McastGroup]


class ForwardingTables(NamedTuple):
    """Device forwarding tables; padded, with device-resident row counts.

    lp_* rows are sorted by flipped pod IP; rn_* rows are sorted disjoint
    [lo, hi] (inclusive, flipped-space) remote podCIDR intervals.  tc words
    pack action | target_port << 2.  local_range holds this node's podCIDR
    as (lo_f, hi_f) — an empty topology uses an empty interval (lo > hi).
    """

    lp_ip_f: np.ndarray  # (Lcap,) i32 sorted flipped local pod IPs
    lp_port: np.ndarray  # (Lcap,) i32 ofports
    lp_tc_in: np.ndarray  # (Lcap,) i32 packed ingress-direction TC word
    lp_tc_eg: np.ndarray  # (Lcap,) i32 packed egress-direction TC word
    n_lp: np.ndarray  # (1,) i32 live row count
    rn_lo_f: np.ndarray  # (Rcap,) i32
    rn_hi_f: np.ndarray  # (Rcap,) i32 inclusive
    rn_peer_f: np.ndarray  # (Rcap,) i32 flipped peer node IP
    n_rn: np.ndarray  # (1,) i32
    local_range_f: np.ndarray  # (2,) i32 [lo_f, hi_f] of the local podCIDR
    mc_ip_f: np.ndarray  # (Mcap,) i32 sorted flipped joined group IPs
    n_mc: np.ndarray  # (1,) i32
    # ARP responder table (pipeline.go ARPResponder): every address this
    # node answers ARP for — gateway IP, local pod IPs, remote node IPs.
    arp_ip_f: np.ndarray  # (Acap,) i32 sorted flipped
    n_arp: np.ndarray  # (1,) i32
    # v6 sub-tables (route_linux.go v6 routes/neighbors).  lp6 rows are
    # sorted lexicographically by flipped word quadruple; rn6 rows are
    # disjoint inclusive [lo, hi] word intervals sorted by lo; nd_ipw is
    # the Neighbor Discovery responder set (the NDP analog of the ARP
    # table: gateway6 + local v6 pods + remote node v6 IPs).
    lp6_ipw: np.ndarray  # (L6cap, 4) i32
    lp6_port: np.ndarray  # (L6cap,) i32
    lp6_tc_in: np.ndarray  # (L6cap,) i32
    lp6_tc_eg: np.ndarray  # (L6cap,) i32
    n_lp6: np.ndarray  # (1,) i32
    rn6_lo_w: np.ndarray  # (R6cap, 4) i32
    rn6_hi_w: np.ndarray  # (R6cap, 4) i32 inclusive
    rn6_peer_w: np.ndarray  # (R6cap, 4) i32 peer node addr (v4-mapped ok)
    n_rn6: np.ndarray  # (1,) i32
    local_range6_w: np.ndarray  # (2, 4) i32 [lo_w, hi_w] (lo > hi = empty)
    nd_ipw: np.ndarray  # (N6cap, 4) i32
    n_nd: np.ndarray  # (1,) i32


def _cap(n: int, floor: int = 8) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


def _flip(u: int) -> int:
    return int(iputil.flip_u32(np.uint32(u)))


def pack_tc(action: int, target_port: int) -> int:
    return action | (target_port << 2)


def unpack_tc(word: int) -> tuple[int, int]:
    return word & 3, word >> 2


def compile_topology(topo: Topology) -> ForwardingTables:
    """-> host (numpy) ForwardingTables; models/forwarding.fwd_to_device
    uploads them.  Raises on overlapping remote podCIDRs or duplicate local
    pod IPs (config errors, never silent last-writer-wins — same observable
    rule as compile_services).

    Dual-stack: local pods / remote podCIDRs split by family into the
    narrow and lexicographic sub-tables; the ip<->ofport bijection the
    SpoofGuard probe relies on holds PER FAMILY (a dual-stack pod binds
    one v4 and one v6 address to its port, like the reference's
    per-family spoof-guard flows)."""
    # Local pods, split by family, each sorted by (flipped) address.
    pods = {}  # v4 u32 -> port
    pods6 = {}  # combined v6 key -> port
    by_port4: dict[int, int] = {}
    by_port6: dict[int, int] = {}
    for ip, port in topo.local_pods:
        if port < FIRST_POD_OFPORT:
            raise ValueError(f"pod ofport {port} collides with reserved ports")
        if iputil.is_v6(ip):
            k = iputil.ip_to_key(ip)
            if k in pods6 and pods6[k] != port:
                raise ValueError(f"duplicate local pod IP {ip}")
            if by_port6.get(port, k) != k:
                raise ValueError(f"duplicate pod ofport {port} (v6)")
            pods6[k] = port
            by_port6[port] = k
            continue
        u = iputil.ip_to_u32(ip)
        if u == 0xFFFFFFFF:
            raise ValueError("255.255.255.255 is not a valid pod IP")
        if u in pods and pods[u] != port:
            raise ValueError(f"duplicate local pod IP {ip}")
        if by_port4.get(port, u) != u:
            # The device SpoofGuard probe relies on the ip<->ofport bijection
            # (it resolves the pod by source IP, the scalar spec by port) —
            # per family: a port may bind one v4 AND one v6 address.
            raise ValueError(f"duplicate pod ofport {port}")
        pods[u] = port
        by_port4[port] = u
    # TC marks resolve per-pod at compile time (appliedTo is a pod set, ref
    # trafficcontrol controller resolving appliedTo to ofports). Later rules
    # win on overlap, matching dict-update order below.
    tc_in: dict[int, int] = {}
    tc_eg: dict[int, int] = {}
    tc_in6: dict[int, int] = {}
    tc_eg6: dict[int, int] = {}
    for r in topo.tc_rules:
        w = pack_tc(r.action, r.target_port)
        for ip in r.pod_ips:
            if iputil.is_v6(ip):
                k = iputil.ip_to_key(ip)
                if k not in pods6:
                    continue
                if r.direction in ("ingress", "both"):
                    tc_in6[k] = w
                if r.direction in ("egress", "both"):
                    tc_eg6[k] = w
                continue
            u = iputil.ip_to_u32(ip)
            if u not in pods:
                continue  # appliedTo pod not on this node
            if r.direction in ("ingress", "both"):
                tc_in[u] = w
            if r.direction in ("egress", "both"):
                tc_eg[u] = w

    order = sorted(pods)
    L = len(order)
    Lcap = _cap(L)
    lp_ip_f = np.full(Lcap, _I32_MAX, np.int32)
    lp_port = np.zeros(Lcap, np.int32)
    lp_tc_in = np.zeros(Lcap, np.int32)
    lp_tc_eg = np.zeros(Lcap, np.int32)
    for i, u in enumerate(order):
        lp_ip_f[i] = _flip(u)
        lp_port[i] = pods[u]
        lp_tc_in[i] = tc_in.get(u, 0)
        lp_tc_eg[i] = tc_eg.get(u, 0)

    order6 = sorted(pods6)  # combined-key order == word-lex order
    L6 = len(order6)
    L6cap = _cap(L6)
    lp6_ipw = np.full((L6cap, 4), _I32_MAX, np.int32)
    lp6_port = np.zeros(L6cap, np.int32)
    lp6_tc_in = np.zeros(L6cap, np.int32)
    lp6_tc_eg = np.zeros(L6cap, np.int32)
    for i, k in enumerate(order6):
        lp6_ipw[i] = iputil.key_to_flipped_words(k)
        lp6_port[i] = pods6[k]
        lp6_tc_in[i] = tc_in6.get(k, 0)
        lp6_tc_eg[i] = tc_eg6.get(k, 0)

    # Remote node podCIDR intervals, split by family, sorted by lo; must
    # be disjoint per family.  A v4 podCIDR needs a v4 tunnel peer (the
    # narrow peer column); v6 podCIDRs accept a peer of either family
    # (v6-over-v4 underlay), stored in wide mapped form.
    ranges = []
    ranges6 = []
    for nr in topo.remote_nodes:
        if iputil.is_v6(nr.pod_cidr):
            lo, hi = iputil.cidr_to_range(nr.pod_cidr)  # combined [lo, hi)
            ranges6.append((lo, hi, iputil.ip_to_key(nr.node_ip), nr.name))
        else:
            if iputil.is_v6(nr.node_ip):
                raise ValueError(
                    f"remote node {nr.name}: v4 podCIDR {nr.pod_cidr} needs "
                    f"a v4 tunnel peer, got {nr.node_ip} (same-family "
                    f"tunnel source selection, ref route_linux.go)"
                )
            lo, hi = iputil.cidr_to_range_v4(nr.pod_cidr)  # [lo, hi) raw u32
            ranges.append((lo, hi, iputil.ip_to_u32(nr.node_ip), nr.name))
    ranges.sort()
    for a, b in zip(ranges, ranges[1:]):
        if b[0] < a[1]:
            raise ValueError(
                f"overlapping remote podCIDRs: {a[3]} and {b[3]}"
            )
    ranges6.sort()
    for a, b in zip(ranges6, ranges6[1:]):
        if b[0] < a[1]:
            raise ValueError(
                f"overlapping remote v6 podCIDRs: {a[3]} and {b[3]}"
            )
    R = len(ranges)
    Rcap = _cap(R)
    # Padding rows use lo = hi = I32_MAX so rn_hi_f stays ascending for
    # searchsorted; lookups additionally guard row < n_rn so a broadcast
    # dst (flips to I32_MAX) can never match a pad row.
    rn_lo_f = np.full(Rcap, _I32_MAX, np.int32)
    rn_hi_f = np.full(Rcap, _I32_MAX, np.int32)
    rn_peer_f = np.zeros(Rcap, np.int32)
    for i, (lo, hi, peer, _name) in enumerate(ranges):
        rn_lo_f[i] = _flip(lo)
        rn_hi_f[i] = _flip(hi - 1)  # inclusive
        rn_peer_f[i] = _flip(peer)

    if topo.pod_cidr:
        llo, lhi = iputil.cidr_to_range_v4(topo.pod_cidr)
        local_range = np.array([_flip(llo), _flip(lhi - 1)], np.int32)
    else:
        local_range = np.array([_I32_MAX, _I32_MIN], np.int32)  # empty

    R6 = len(ranges6)
    R6cap = _cap(R6)
    rn6_lo_w = np.full((R6cap, 4), _I32_MAX, np.int32)
    rn6_hi_w = np.full((R6cap, 4), _I32_MIN, np.int32)  # empty pad rows
    rn6_peer_w = np.zeros((R6cap, 4), np.int32)
    for i, (lo, hi, peer, _name) in enumerate(ranges6):
        rn6_lo_w[i] = iputil.key_to_flipped_words(lo)
        rn6_hi_w[i] = iputil.key_to_flipped_words(hi - 1)  # inclusive
        rn6_peer_w[i] = iputil.key_to_flipped_words(peer)

    if topo.pod_cidr6:
        llo6, lhi6 = iputil.cidr_to_range(topo.pod_cidr6)
        local_range6 = np.array(
            [iputil.key_to_flipped_words(llo6),
             iputil.key_to_flipped_words(lhi6 - 1)], np.int32)
    else:
        local_range6 = np.array(
            [[_I32_MAX] * 4, [_I32_MIN] * 4], np.int32)  # empty (lo > hi)

    # Neighbor Discovery responder set (the NDP analog of ARPResponder;
    # ref route_linux.go v6 neighbor programming): gateway6 + local v6
    # pods + remote node v6 IPs.
    nd_set = set(pods6)
    if topo.gateway_ip6:
        nd_set.add(iputil.ip_to_key(topo.gateway_ip6))
    for nr in topo.remote_nodes:
        if iputil.is_v6(nr.node_ip):
            nd_set.add(iputil.ip_to_key(nr.node_ip))
    nd_sorted = sorted(nd_set)
    N6 = len(nd_sorted)
    N6cap = _cap(N6)
    nd_ipw = np.full((N6cap, 4), _I32_MAX, np.int32)
    for i, k in enumerate(nd_sorted):
        nd_ipw[i] = iputil.key_to_flipped_words(k)

    # Joined multicast groups, sorted by flipped group IP; the row index is
    # the mcast_idx the kernel reports (Datapath.mcast_group resolves it).
    mg = sorted({_flip(iputil.ip_to_u32(g.group_ip)) for g in topo.mcast_groups})
    if len(mg) != len(topo.mcast_groups):
        raise ValueError("duplicate multicast group")
    for f in mg:
        if not (MCAST_LO_F <= f <= MCAST_HI_F):
            raise ValueError("mcast group outside 224.0.0.0/4")
    M = len(mg)
    Mcap = _cap(M)
    mc_ip_f = np.full(Mcap, _I32_MAX, np.int32)
    mc_ip_f[:M] = np.array(mg, np.int32) if M else mc_ip_f[:0]

    # ARP responder set (pipeline.go ARPResponder): gateway + local pods +
    # remote node IPs — the addresses arp_respond (the scalar spec) answers.
    arp_set = {u for u in pods}
    if topo.gateway_ip:
        arp_set.add(iputil.ip_to_u32(topo.gateway_ip))
    for nr in topo.remote_nodes:
        if not iputil.is_v6(nr.node_ip):  # v6 peers answer ND, not ARP
            arp_set.add(iputil.ip_to_u32(nr.node_ip))
    as_f = sorted(_flip(u) for u in arp_set)
    A = len(as_f)
    Acap = _cap(A)
    arp_ip_f = np.full(Acap, _I32_MAX, np.int32)
    arp_ip_f[:A] = np.array(as_f, np.int32) if A else arp_ip_f[:0]

    return ForwardingTables(
        lp_ip_f=lp_ip_f, lp_port=lp_port,
        lp_tc_in=lp_tc_in, lp_tc_eg=lp_tc_eg,
        n_lp=np.array([L], np.int32),
        rn_lo_f=rn_lo_f, rn_hi_f=rn_hi_f, rn_peer_f=rn_peer_f,
        n_rn=np.array([R], np.int32),
        local_range_f=local_range,
        mc_ip_f=mc_ip_f,
        n_mc=np.array([M], np.int32),
        arp_ip_f=arp_ip_f,
        n_arp=np.array([A], np.int32),
        lp6_ipw=lp6_ipw,
        lp6_port=lp6_port,
        lp6_tc_in=lp6_tc_in,
        lp6_tc_eg=lp6_tc_eg,
        n_lp6=np.array([L6], np.int32),
        rn6_lo_w=rn6_lo_w,
        rn6_hi_w=rn6_hi_w,
        rn6_peer_w=rn6_peer_w,
        n_rn6=np.array([R6], np.int32),
        local_range6_w=local_range6,
        nd_ipw=nd_ipw,
        n_nd=np.array([N6], np.int32),
    )


# ---- host-side ARP responder / MAC scheme -----------------------------------


def mac_of_ip(ip: str) -> str:
    """Deterministic locally-administered MAC for an IP — the analog of the
    reference deriving pod/gateway interface MACs at configure time
    (pkg/agent/cniserver/pod_configuration.go interface MAC generation);
    deterministic so both datapaths and restarted agents agree.  v6
    addresses derive from their low 32 bits (EUI-style suffix)."""
    u = iputil.ip_to_key(ip) & 0xFFFFFFFF
    return "0a:00:%02x:%02x:%02x:%02x" % (
        (u >> 24) & 0xFF, (u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF
    )


def arp_respond(topo: Topology, target_ip: str) -> Optional[str]:
    """ARP responder (ref pipeline.go ARPResponder: the agent answers ARP
    for the local gateway and for remote-node gateway/peer addresses so pod
    ARP never floods the underlay).  Answers for: the local gateway IP,
    any local pod IP (proxy for intra-node L2), and remote node IPs.
    -> MAC string, or None when the address is not ours to answer.
    ARP is a v4 protocol — v6 targets go through nd_respond."""
    if not target_ip or iputil.is_v6(target_ip):
        return None
    if topo.gateway_ip and target_ip == topo.gateway_ip:
        return mac_of_ip(target_ip)
    u = iputil.ip_to_u32(target_ip)
    for ip, _port in topo.local_pods:
        if not iputil.is_v6(ip) and iputil.ip_to_u32(ip) == u:
            return mac_of_ip(target_ip)
    for nr in topo.remote_nodes:
        if not iputil.is_v6(nr.node_ip) and iputil.ip_to_u32(nr.node_ip) == u:
            return mac_of_ip(target_ip)
    return None


def nd_respond(topo: Topology, target_ip: str) -> Optional[str]:
    """Neighbor Discovery responder — the v6 twin of arp_respond (ref
    route_linux.go v6 neighbor programming: the agent answers NS for the
    v6 gateway, local v6 pods and remote node v6 addresses)."""
    if not target_ip or not iputil.is_v6(target_ip):
        return None
    k = iputil.ip_to_key(target_ip)
    if topo.gateway_ip6 and iputil.ip_to_key(topo.gateway_ip6) == k:
        return mac_of_ip(target_ip)
    for ip, _port in topo.local_pods:
        if iputil.is_v6(ip) and iputil.ip_to_key(ip) == k:
            return mac_of_ip(target_ip)
    for nr in topo.remote_nodes:
        if iputil.is_v6(nr.node_ip) and iputil.ip_to_key(nr.node_ip) == k:
            return mac_of_ip(target_ip)
    return None


# ---- scalar oracle (the spec for models/forwarding.py) ----------------------


@dataclass
class ResolvedTopology:
    """Topology with IPs pre-parsed to COMBINED-keyspace ints (utils/ip.py
    — v4 values are their plain u32) — the scalar-spec working form, built
    ONCE per install so the per-packet oracle loops never re-parse address
    strings (OracleDatapath steps whole batches through these).  The
    combined keyspace makes every membership/range check family-agnostic,
    exactly like the policy oracle."""

    pod_by_u32: dict  # combined key -> ofport (name kept for v4 history)
    pod_by_port: dict  # ofport -> set of bound keys (one per family)
    remote: list  # [(lo, hi_exclusive, peer_key)] sorted, both families
    local: list  # [(lo, hi_exclusive)] local podCIDR ranges, both families
    # Multicast: groups in table order (sorted by u32 == sorted by flipped
    # i32, so idx here == the kernel's mcast_idx) + the idx lookup map.
    mcast: list = field(default_factory=list)  # [McastGroup], table order
    mcast_idx: dict = field(default_factory=dict)  # group u32 -> idx
    node_ip_by_name: dict = field(default_factory=dict)  # remote node -> key
    arp_u32: set = field(default_factory=set)  # ARP-answerable v4 addresses
    nd_keys: set = field(default_factory=set)  # ND-answerable v6 keys


def resolve_topology(topo: Topology) -> ResolvedTopology:
    pod_by_u32 = {iputil.ip_to_key(ip): port for ip, port in topo.local_pods}
    pod_by_port: dict[int, set] = {}
    for k, p in pod_by_u32.items():
        pod_by_port.setdefault(p, set()).add(k)
    remote = sorted(
        iputil.cidr_to_range(nr.pod_cidr) + (iputil.ip_to_key(nr.node_ip),)
        for nr in topo.remote_nodes
    )
    local = []
    if topo.pod_cidr:
        local.append(iputil.cidr_to_range_v4(topo.pod_cidr))
    if topo.pod_cidr6:
        local.append(iputil.cidr_to_range(topo.pod_cidr6))
    mg = sorted(
        (iputil.ip_to_u32(g.group_ip), g) for g in topo.mcast_groups
    )
    return ResolvedTopology(
        pod_by_u32=pod_by_u32,
        pod_by_port=pod_by_port,
        remote=remote,
        local=local,
        mcast=[g for _u, g in mg],
        mcast_idx={u: i for i, (u, _g) in enumerate(mg)},
        node_ip_by_name={
            nr.name: iputil.ip_to_key(nr.node_ip) for nr in topo.remote_nodes
        },
        arp_u32=(
            {k for k in pod_by_u32 if not iputil.key_is_v6(k)}
            | ({iputil.ip_to_u32(topo.gateway_ip)} if topo.gateway_ip else set())
            | {iputil.ip_to_u32(nr.node_ip) for nr in topo.remote_nodes
               if not iputil.is_v6(nr.node_ip)}
        ),
        nd_keys=(
            {k for k in pod_by_u32 if iputil.key_is_v6(k)}
            | ({iputil.ip_to_key(topo.gateway_ip6)}
               if topo.gateway_ip6 else set())
            | {iputil.ip_to_key(nr.node_ip) for nr in topo.remote_nodes
               if iputil.is_v6(nr.node_ip)}
        ),
    )


def is_mcast_u32(ip: int) -> bool:
    return 0xE0000000 <= ip <= 0xEFFFFFFF


def mcast_group_of(rt: ResolvedTopology, idx: int) -> Optional[dict]:
    """mcast_idx -> {group, ports (local receiver ofports), peers (remote
    node IPs, u32)} — the MulticastOutput replication bucket list (ref
    pkg/agent/openflow/multicast.go group buckets: one bucket per local
    receiver port + one per interested remote node)."""
    if not (0 <= idx < len(rt.mcast)):
        return None
    g = rt.mcast[idx]
    return {
        "group": g.group_ip,
        "ports": list(g.local_ports),
        "peers": [
            rt.node_ip_by_name[n]
            for n in g.remote_nodes
            if n in rt.node_ip_by_name
        ],
    }


def oracle_spoof(rt: ResolvedTopology, src_ip: int, in_port: int) -> bool:
    """SpoofGuard spec (ref pipeline.go SpoofGuard table): a packet entering
    on a pod ofport must carry ONE of that pod's bound source addresses
    (per family — a dual-stack pod binds a v4 and a v6 address).  Packets
    from the tunnel/gateway/unset ports are exempt (they were guarded at
    their own ingress node).  An unknown pod port has no legitimate
    sender.  src_ip is a combined-keyspace int."""
    if in_port < FIRST_POD_OFPORT:
        return False
    return src_ip not in rt.pod_by_port.get(in_port, ())


def oracle_forward(rt: ResolvedTopology, dst_ip: int, in_port: int) -> dict:
    """Scalar forwarding spec -> {kind, out_port, peer_ip, dec_ttl
    [, mcast_idx]}.  dst_ip is a combined-keyspace int, so every branch
    below is family-agnostic; peer_ip comes back as a combined key."""
    if not iputil.key_is_v6(dst_ip) and is_mcast_u32(dst_ip):
        idx = rt.mcast_idx.get(dst_ip)
        if idx is None:
            # MulticastRouting miss: no receivers anywhere -> drop.
            return {"kind": FWD_DROP_MCAST, "out_port": -1, "peer_ip": 0,
                    "dec_ttl": False, "mcast_idx": -1}
        return {"kind": FWD_MCAST, "out_port": OFPORT_REPLICATE, "peer_ip": 0,
                "dec_ttl": False, "mcast_idx": idx}
    port = rt.pod_by_u32.get(dst_ip)
    if port is not None:
        # Routed legs decrement TTL (ref pipeline.go L3DecTTL: traffic
        # arriving via tunnel or gateway was routed to this pod).
        dec = in_port in (OFPORT_TUNNEL, OFPORT_GATEWAY)
        return {"kind": FWD_LOCAL, "out_port": port, "peer_ip": 0,
                "dec_ttl": dec}
    for lo, hi, peer in rt.remote:
        if lo <= dst_ip < hi:
            return {"kind": FWD_TUNNEL, "out_port": OFPORT_TUNNEL,
                    "peer_ip": peer, "dec_ttl": True}
    if any(lo <= dst_ip < hi for lo, hi in rt.local):
        return {"kind": FWD_DROP_UNKNOWN, "out_port": -1, "peer_ip": 0,
                "dec_ttl": False}
    return {"kind": FWD_GATEWAY, "out_port": OFPORT_GATEWAY, "peer_ip": 0,
            "dec_ttl": True}


def _tc_from_tables(t: ForwardingTables, src_ip: int, dst_ip: int):
    """TC resolution over the compiled tables; addresses are combined-
    keyspace ints, routed to the narrow or lexicographic pod table by
    family."""
    def row_of(key):
        if iputil.key_is_v6(key):
            w = np.asarray(iputil.key_to_flipped_words(key), np.int32)
            for i in range(int(t.n_lp6[0])):
                if (t.lp6_ipw[i] == w).all():
                    return i, t.lp6_tc_in, t.lp6_tc_eg
            return None, None, None
        f = _flip(key)
        i = int(np.searchsorted(t.lp_ip_f, f))
        if i < int(t.n_lp[0]) and t.lp_ip_f[i] == f:
            return i, t.lp_tc_in, t.lp_tc_eg
        return None, None, None

    d, d_in, _d_eg = row_of(dst_ip)
    if d is not None and d_in[d]:
        return unpack_tc(int(d_in[d]))
    s, _s_in, s_eg = row_of(src_ip)
    if s is not None and s_eg[s]:
        return unpack_tc(int(s_eg[s]))
    return TC_NONE, 0
