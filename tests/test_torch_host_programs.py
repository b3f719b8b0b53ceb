"""The node agent's host programs on the PyTorch port's engine (on the CPU),
each held to the JAX original on the JAX engine with the same inputs: the
NetworkPolicy audit log read from step results, the IGMP snooping loop
(punt -> packet-in dispatcher -> MulticastController -> topology
reinstall), NodePortLocal's DNAT through Service entries, and a multi-
cluster import's cross-cluster DNAT.  Every output compared is bitwise
equal; each scenario follows the JAX package's own test of it
(tests/test_observability.py, test_igmp_mcast.py, test_nodeportlocal.py,
test_multicluster.py)."""

import numpy as np

from antrea_tpu import datapath as jdp
from antrea_tpu import packet as jpk
from antrea_tpu.agent import multicast as jmc
from antrea_tpu.agent import nodeportlocal as jnpl
from antrea_tpu.agent import noderoute as jnr
from antrea_tpu.agent import packetin as jpi
from antrea_tpu.apis import controlplane as jcp
from antrea_tpu.apis import service as jsvc
from antrea_tpu.compiler import ir as jir
from antrea_tpu.compiler import topology as jtopo
from antrea_tpu.observability import audit as jaudit
from antrea_tpu import multicluster as jmcl
from antrea_tpu_torch import datapath as tdp
from antrea_tpu_torch import packet as tpk
from antrea_tpu_torch.agent import multicast as tmc
from antrea_tpu_torch.agent import nodeportlocal as tnpl
from antrea_tpu_torch.agent import noderoute as tnr
from antrea_tpu_torch.agent import packetin as tpi
from antrea_tpu_torch.apis import controlplane as tcp
from antrea_tpu_torch.apis import service as tsvc
from antrea_tpu_torch.compiler import ir as tir
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.observability import audit as taudit
from antrea_tpu_torch import multicluster as tmcl
from antrea_tpu_torch.utils import ip as iputil

import torch_cpu  # noqa: F401  (one torch thread a worker)

JAX = dict(dp=jdp, pk=jpk, mc=jmc, npl=jnpl, nr=jnr, pi=jpi, cp=jcp,
           svc=jsvc, ir=jir, topo=jtopo, audit=jaudit, mcl=jmcl, kw={})
PORT = dict(dp=tdp, pk=tpk, mc=tmc, npl=tnpl, nr=tnr, pi=tpi, cp=tcp,
            svc=tsvc, ir=tir, topo=ttopo, audit=taudit, mcl=tmcl,
            kw=dict(device="cpu"))
KW = dict(flow_slots=1 << 10, aff_slots=1 << 8)


def _batch(pkg, rows, proto=6, in_port=None):
    """rows: [(src, dst, sport, dport)]."""
    kw = {}
    if in_port is not None:
        kw["in_port"] = np.asarray(in_port, np.int32)
    return pkg["pk"].PacketBatch(
        src_ip=np.array([iputil.ip_to_u32(s) for s, _, _, _ in rows],
                        np.uint32),
        dst_ip=np.array([iputil.ip_to_u32(d) for _, d, _, _ in rows],
                        np.uint32),
        proto=np.full(len(rows), proto, np.int32),
        src_port=np.array([sp for _, _, sp, _ in rows], np.int32),
        dst_port=np.array([dp for _, _, _, dp in rows], np.int32), **kw)


def _fields(r, names):
    return {f: np.asarray(getattr(r, f)).tolist() for f in names}


def _both(run):
    """run(pkg) for the JAX package then the port -> the two results."""
    return run(JAX), run(PORT)


def _deny_ps(pkg):
    cp = pkg["cp"]
    ps = pkg["ir"].PolicySet()
    ps.applied_to_groups["atg"] = cp.AppliedToGroup(
        "atg", [cp.GroupMember(ip="10.0.0.10", node="n0")])
    ps.policies.append(cp.NetworkPolicy(
        uid="deny-in", name="deny-in", type=cp.NetworkPolicyType.ACNP,
        applied_to_groups=["atg"], tier_priority=cp.TIER_APPLICATION,
        priority=1.0,
        rules=[cp.NetworkPolicyRule(direction=cp.Direction.IN,
                                    action=cp.RuleAction.REJECT,
                                    priority=0)]))
    ps.applied_to_groups["iso"] = cp.AppliedToGroup(
        "iso", [cp.GroupMember(ip="10.0.0.30", node="n0")])
    ps.policies.append(cp.NetworkPolicy(
        uid="np", name="np", namespace="default",
        type=cp.NetworkPolicyType.K8S, rules=[], applied_to_groups=["iso"],
        policy_types=[cp.Direction.IN]))
    return ps


def test_audit_records_equal_the_jax_engines(tmp_path):
    """The audit log over each package's engine, a REJECT rule's TCP and
    UDP flows, a K8s isolation drop and an allowed flow, observed at t = 1,
    2, 3 (one dedup window) and 20: the records (rule, verdict, reject
    kind, 5-tuple, counts) and the lines written equal."""
    rows = [("10.0.0.5", "10.0.0.10", 41000, 80),
            ("10.0.0.5", "10.0.0.30", 41001, 80),
            ("10.0.0.5", "10.0.0.99", 41002, 80)]

    def run(pkg):
        ps = _deny_ps(pkg)
        dp = pkg["dp"].TpuflowDatapath(ps, [], miss_chunk=16, **KW,
                                       **pkg["kw"])
        path = tmp_path / f"{id(pkg)}.log"
        log = pkg["audit"].AuditLogger(
            dedup_s=5, deny_rules=pkg["audit"].deny_rule_ids(ps),
            path=str(path))
        for proto in (6, 17):
            b = _batch(pkg, rows, proto)
            for now in (1, 2, 3):
                log.observe(b, dp.step(b, now), now)
            log.observe(b, dp.step(b, 20), 20)
        log.flush(now=99, force=True)
        return [r.line() for r in log.records], path.read_text()

    (jrec, jtext), (trec, ttext) = _both(run)
    assert trec == jrec and ttext == jtext
    assert len(trec) == 8
    assert sum("tcp-rst" in x for x in trec) == 2
    assert sum("icmp-unreach" in x for x in trec) == 2
    assert sum("DefaultDeny" in x for x in trec) == 4
    assert not any("10.0.0.99" in x for x in trec)


def _mcast_topo(pkg):
    topo = pkg["topo"]
    return topo.Topology(
        node_name="node-a", gateway_ip="10.10.0.1", pod_cidr="10.10.0.0/24",
        local_pods=[("10.10.0.5", 3), ("10.10.0.6", 4)],
        remote_nodes=[topo.NodeRoute(name="node-b", node_ip="192.168.1.2",
                                     pod_cidr="10.10.1.0/24")],
        mcast_groups=[])


def test_igmp_snooping_loop_equals_the_jax_engine():
    """IGMP report punt -> dispatcher -> MulticastController -> topology
    reinstall, then data replicates; a leave withdraws the group; a rejoin,
    then the member timeout expires it; a remote node's interest: each
    step's punt, fwd_kind, out_port and mcast_idx, and the group each lane
    replicates to (mcast_group), equal across the packages."""
    def run(pkg):
        mc, pi, topo = pkg["mc"], pkg["pi"], pkg["topo"]
        dp = pkg["dp"].TpuflowDatapath(topology=_mcast_topo(pkg),
                                       miss_chunk=64, **KW, **pkg["kw"])
        nrc = pkg["nr"].NodeRouteController(dp, "node-a",
                                            pod_cidr="10.10.0.0/24")
        nrc.pod_added("10.10.0.5", 3)
        nrc.pod_added("10.10.0.6", 4)
        nrc.upsert_node("node-b", "192.168.1.2", "10.10.1.0/24")
        disp = pi.PacketInDispatcher()
        ctl = mc.MulticastController(nrc, dispatcher=disp,
                                     member_timeout_s=100)
        rep = _batch(pkg, [("10.10.0.6", "239.2.2.2", mc.IGMP_REPORT, 0)],
                     topo.PROTO_IGMP, in_port=[4])
        leave = _batch(pkg, [("10.10.0.6", "239.2.2.2", mc.IGMP_LEAVE, 0)],
                       topo.PROTO_IGMP, in_port=[4])
        data = _batch(pkg, [("10.10.0.5", "239.2.2.2", 40000, 5000),
                            ("10.10.0.6", "239.2.2.2", 40001, 5000),
                            ("10.10.0.5", "239.3.3.3", 40002, 5000)], 17,
                      in_port=[3, 4, 3])
        out = []

        def step(b, now, punt=False):
            r = dp.step(b, now)
            if punt:
                out.append(("collected", disp.collect(b, r, now),
                            disp.drain(now)))
            out.append(_fields(r, ("punt", "fwd_kind", "out_port",
                                   "mcast_idx", "code")))
            out.append([dp.mcast_group(int(i)) if i >= 0 else None
                        for i in np.asarray(r.mcast_idx)])

        step(rep, 10, punt=True)
        step(data, 11)
        step(leave, 12, punt=True)
        step(data, 13)
        step(rep, 20, punt=True)
        step(data, 21)
        out.append(("expired", ctl.expire(now=121)))
        step(data, 122)
        ctl.set_remote_interest("239.3.3.3", ["node-b"])
        step(data, 123)
        return out, topo.FWD_MCAST

    (jout, jmcast), (tout, tmcast) = _both(run)
    assert tout == jout and tmcast == jmcast
    kinds = [x["fwd_kind"] for x in tout if isinstance(x, dict)]
    assert [tmcast, tmcast] == kinds[1][:2]  # the join replicates
    assert tmcast not in kinds[3][:2]  # the leave withdrew it
    assert ("expired", 1) in tout


def test_nodeportlocal_dnat_equals_the_jax_engine():
    """NodePortLocal allocations become Service entries: an external client
    to node_ip:npl_port DNATs to the pod with its address kept (snat 0),
    and the reply leg restores the node frontend; a second pod port and a
    released one; code, snat, DNAT, reply and committed equal."""
    node_ip = "192.168.1.10"

    def run(pkg):
        npl = pkg["npl"].NplController(
            [node_ip], port_range=pkg["npl"].DEFAULT_PORT_RANGE)
        p1 = npl.add_pod_port("10.0.0.5", 6, 8080)
        p2 = npl.add_pod_port("10.0.0.6", 6, 9090)
        p3 = npl.add_pod_port("10.0.0.7", 6, 7070)
        npl.remove_pod_port("10.0.0.7", 6, 7070)
        dp = pkg["dp"].TpuflowDatapath(None, npl.service_entries(),
                                       miss_chunk=64, **KW, **pkg["kw"])
        fwd = _batch(pkg, [("203.0.113.7", node_ip, 40000, p1),
                           ("203.0.113.8", node_ip, 40001, p2),
                           ("203.0.113.9", node_ip, 40002, p3)])
        reply = _batch(pkg, [("10.0.0.5", "203.0.113.7", 8080, 40000),
                             ("10.0.0.6", "203.0.113.8", 9090, 40001)])
        names = ("code", "snat", "svc_idx", "dnat_ip", "dnat_port", "reply",
                 "committed")
        return ((p1, p2, p3), _fields(dp.step(fwd, 1), names),
                _fields(dp.step(reply, 2), names))

    jout, tout = _both(run)
    assert tout == jout
    ports, fwd, reply = tout
    assert fwd["dnat_ip"][:2] == [iputil.ip_to_u32("10.0.0.5"),
                                  iputil.ip_to_u32("10.0.0.6")]
    assert fwd["dnat_port"][:2] == [8080, 9090] and fwd["snat"][:2] == [0, 0]
    assert reply["reply"] == [1, 1]
    assert reply["dnat_port"] == list(ports[:2])


def test_cross_cluster_traffic_equals_the_jax_engine():
    """A ClusterSet of three members: east and west export prod/web, south
    imports it with both clusters' endpoints and compiles it into its
    engine like any Service.  The imports (ClusterIP, port, endpoints) and
    south's verdicts and DNAT to the remote clusters' pods equal across
    the packages; then west
    retracts and the import keeps east's endpoint alone."""
    def run(pkg):
        svc, mcl = pkg["svc"], pkg["mcl"]
        cs = mcl.ClusterSet()
        members = {n: cs.add_member(n) for n in ("east", "west", "south")}
        for n, vip, eps in (("east", "10.96.0.10", ["10.1.0.5", "10.1.0.6"]),
                            ("west", "10.97.0.10", ["10.2.0.9"])):
            s = svc.ServiceEntry(vip, 80, 6,
                                 [svc.Endpoint(ip, 8080) for ip in eps],
                                 name="web", namespace="prod")
            members[n].add_local_service("prod", s)
            cs.leader.export_service(n, "prod", s)
        south = members["south"]
        out = []
        for phase in ("both", "east"):
            imp = south.imported[("prod", "web")]
            out.append((imp.name, imp.cluster_ip, imp.port,
                        sorted((e.ip, e.port) for e in imp.endpoints)))
            dp = pkg["dp"].TpuflowDatapath(None, south.all_services(),
                                           miss_chunk=16, **KW, **pkg["kw"])
            b = _batch(pkg, [("10.3.0.50", imp.cluster_ip, 41000 + k, 80)
                             for k in range(32)])
            out.append(_fields(dp.step(b, 10), ("code", "svc_idx",
                                                "dnat_ip", "dnat_port")))
            if phase == "both":
                cs.leader.retract_export("west", "prod", "web")
        return out

    jout, tout = _both(run)
    assert tout == jout
    reached = set(tout[1]["dnat_ip"])
    assert reached == {iputil.ip_to_u32(ip)
                       for ip in ("10.1.0.5", "10.1.0.6", "10.2.0.9")}
    assert set(tout[3]["dnat_ip"]) <= {iputil.ip_to_u32("10.1.0.5"),
                                       iputil.ip_to_u32("10.1.0.6")}
