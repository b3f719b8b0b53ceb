"""The PyTorch port's dissemination wire on the CPU: the mTLS network wire
(dissemination/netwire.py) and the pipe transport to an agent subprocess
(dissemination/transport.py + agent_proc.py), copies of the JAX package's.

- mTLS: the port's server streams a span-filtered world to the port's
  NetAgents (one over the port's engine on the CPU, one over its scalar
  twin), whose verdicts equal the scalar Oracle's before and after a
  withdrawal; a certless client and an agent trusting another CA are
  refused; a FaultPlan connection reset is healed by a reconnect whose
  re-list retracts a policy deleted meanwhile.  The port's wire speaks the
  JAX package's: a port NetAgent is fed by a JAX DisseminationServer.
- Backoff schedules equal the JAX package's for the same seeds.
- The pipe: SubprocessAgent spawns the port's agent_proc (--device cpu
  behind datapath_type="tpuflow"), and its replies equal an in-process port
  agent and engine given the same events, through install and a membership
  delta; a killed child surfaces as AgentDiedError with its exit code and
  stderr tail."""

import random
import socket
import ssl

import numpy as np
import pytest

from antrea_tpu.controller import NetworkPolicyController as JController
from antrea_tpu.dissemination import RamStore as JStore
from antrea_tpu.dissemination import netwire as jnet
from antrea_tpu_torch.agent import AgentPolicyController
from antrea_tpu_torch.apis import controlplane as cp
from antrea_tpu_torch.apis import crd
from antrea_tpu_torch.compiler.compile import ACT_ALLOW, ACT_DROP
from antrea_tpu_torch.controller import NetworkPolicyController
from antrea_tpu_torch.datapath import OracleDatapath, TpuflowDatapath
from antrea_tpu_torch.dissemination import FaultPlan, RamStore
from antrea_tpu_torch.dissemination import netwire as tnet
from antrea_tpu_torch.dissemination.faults import FaultySocket
from antrea_tpu_torch.dissemination.transport import (AgentDiedError,
                                                      SubprocessAgent)
from antrea_tpu_torch.oracle import Oracle
from antrea_tpu_torch.packet import Packet, PacketBatch
from antrea_tpu_torch.utils import ip as iputil
import torch_cpu  # noqa: F401  (one torch thread a worker)

NODES = ("n1", "n2")
ENGINE_KW = dict(flow_slots=1 << 8, aff_slots=1 << 4, miss_chunk=32)


def _pki(tmp_path, mod=tnet, name="pki"):
    certdir = str(tmp_path / name)
    mod.make_ca(certdir)
    return certdir


def _populate(ctl, api=crd):
    ctl.upsert_namespace(api.Namespace(name="default", labels={}))
    for i, node in enumerate(NODES, 1):
        ctl.upsert_pod(api.Pod(namespace="default", name=f"p-{node}",
                               ip=f"10.0.{i}.1", node=node,
                               labels={"app": "web"}))


def _policy(uid="P", cidr="192.0.2.0/24", api=crd, dcp=cp):
    return api.AntreaNetworkPolicy(
        uid=uid, name=uid, namespace="", tier_priority=250, priority=1,
        applied_to=[api.AntreaAppliedTo(
            pod_selector=api.LabelSelector.make({"app": "web"}),
            ns_selector=api.LabelSelector.make())],
        rules=[api.AntreaNPRule(direction=dcp.Direction.IN,
                                action=dcp.RuleAction.DROP,
                                peers=[api.AntreaPeer(
                                    ip_block=api.IPBlock(cidr))])])


def _world(tmp_path):
    certdir = _pki(tmp_path)
    ctl = NetworkPolicyController()
    store = RamStore()
    ctl.subscribe(store.apply)
    srv = tnet.DisseminationServer(store, certdir)
    _populate(ctl)
    return certdir, ctl, store, srv


def _pairs():
    ips = ["10.0.1.1", "10.0.2.1", "192.0.2.7", "198.51.100.9"]
    return [(s, d) for s in ips for d in ips if s != d]


def _verdicts(dp, pairs, now):
    pkts = [Packet(src_ip=iputil.ip_to_u32(s), dst_ip=iputil.ip_to_u32(d),
                   proto=6, src_port=20000 + now, dst_port=80)
            for s, d in pairs]
    return pkts, [int(x) for x in np.asarray(
        dp.step(PacketBatch.from_packets(pkts), now).code)]


def _oracle_parity(ctl, agents, now):
    for node, a in agents.items():
        pkts, got = _verdicts(a.agent.datapath, _pairs(), now)
        oracle = Oracle(ctl.policy_set_for_node(node))
        assert got == [int(oracle.classify(p).code) for p in pkts], node


def _round(srv, agents):
    srv.pump()
    for a in agents.values():
        a.pump()
        a.sync_and_report()
        assert a.agent.sync_failures_total == 0
        assert a.agent.permanent_failure == ""


def _until(srv, agents, uids, rounds=40):
    """Pump rounds until every agent holds exactly `uids` (a change's
    events may ride several TLS records, read over more than one pump)."""
    for _ in range(rounds):
        _round(srv, agents)
        if all([p.uid for p in a.agent.policy_set.policies] == uids
               for a in agents.values()):
            return
    raise AssertionError(f"agents did not converge to {uids}")


def test_backoff_equals_reference():
    for node in ("n1", "agent-7", None):
        a = tnet.Backoff(base=0.05, cap=2.0, rng=random.Random(7), node=node)
        b = jnet.Backoff(base=0.05, cap=2.0, rng=random.Random(7), node=node)
        assert a.node_factor == b.node_factor
        assert ([a.next_delay() for _ in range(12)]
                == [b.next_delay() for _ in range(12)])
    assert tnet.BackoffPolicy is tnet.Backoff


def test_mtls_stream_reaches_the_ports_engine(tmp_path):
    """Both nodes' agents over mutual TLS, one driving the port's engine on
    the CPU and one its scalar twin: the policy, then its withdrawal,
    realized and enforced as the Oracle says."""
    certdir, ctl, store, srv = _world(tmp_path)
    try:
        agents = {
            "n1": tnet.NetAgent("n1", srv.address, certdir,
                                TpuflowDatapath(device="cpu", **ENGINE_KW)),
            "n2": tnet.NetAgent("n2", srv.address, certdir,
                                OracleDatapath(flow_slots=1 << 8,
                                               aff_slots=1 << 4)),
        }
        srv.wait_connected(2)
        ctl.upsert_antrea_policy(_policy())
        _until(srv, agents, ["P"])
        for a in agents.values():
            assert a.agent.datapath.generation >= 1
            assert a.resyncs_total == 1  # the hello snapshot
        _oracle_parity(ctl, agents, 1)
        _, got = _verdicts(agents["n1"].agent.datapath,
                           [("192.0.2.7", "10.0.1.1"),
                            ("10.0.2.1", "10.0.1.1")], 2)
        assert got == [ACT_DROP, ACT_ALLOW]
        ctl.delete_policy("P")
        _until(srv, agents, [])
        _oracle_parity(ctl, agents, 3)
        st = srv.dissemination_stats()
        assert st["resyncs_total"] == 2
        for a in agents.values():
            a.close()
    finally:
        srv.close()


def test_unauthenticated_client_refused(tmp_path):
    """The server requires a CA-signed client certificate."""
    certdir, ctl, store, srv = _world(tmp_path)
    try:
        raw = socket.create_connection(tuple(srv.address))
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        with pytest.raises(ssl.SSLError):
            tls = ctx.wrap_socket(raw, server_hostname="localhost")
            srv.pump()
            tls.sendall(b'{"hello": "evil"}\n')
            srv.pump()
            tls.recv(1)
            tls.recv(1)
        raw.close()
        assert "evil" not in srv._conns
    finally:
        srv.close()


def test_agent_refuses_another_ca(tmp_path):
    certdir, ctl, store, srv = _world(tmp_path)
    other = _pki(tmp_path, name="otherpki")
    try:
        with pytest.raises(ssl.SSLError):
            tnet.NetAgent("n1", srv.address, other,
                          TpuflowDatapath(device="cpu", **ENGINE_KW))
            srv.pump()
    finally:
        srv.close()


def test_fault_plan_reset_reconnects_and_relists(tmp_path):
    """One injected reset on n1's socket while a policy is deleted: n1
    re-dials with backoff, takes the server's re-list and retracts the
    policy it missed; n2 never reconnects."""
    certdir, ctl, store, srv = _world(tmp_path)
    plan = FaultPlan(seed=3)
    try:
        agents = {
            "n1": tnet.NetAgent(
                "n1", srv.address, certdir,
                TpuflowDatapath(device="cpu", **ENGINE_KW),
                backoff=tnet.Backoff(base=0.01, cap=0.05),
                fault_wrap=lambda s: FaultySocket(s, plan, "n1")),
            "n2": tnet.NetAgent("n2", srv.address, certdir,
                                OracleDatapath(flow_slots=1 << 8,
                                               aff_slots=1 << 4)),
        }
        srv.wait_connected(2)
        ctl.upsert_antrea_policy(_policy("P1"))
        _until(srv, agents, ["P1"])
        plan.after("n1.recv", plan.hits("n1.recv"), "reset", times=1)
        ctl.delete_policy("P1")
        srv.pump()
        agents["n1"].pump(wait=0.2)
        assert plan.count("reset") == 1 and not agents["n1"].connected
        ctl.upsert_antrea_policy(_policy("P2", cidr="198.51.100.0/24"))
        for _ in range(60):
            _round(srv, agents)
            if agents["n1"].resyncs_total >= 2:
                break
        _until(srv, agents, ["P2"])
        a1 = agents["n1"]
        assert a1.reconnects_total >= 1 and a1.resyncs_total >= 2
        assert agents["n2"].reconnects_total == 0
        _oracle_parity(ctl, agents, 7)
        for a in agents.values():
            a.close()
    finally:
        srv.close()


def test_ports_agent_reads_the_jax_packages_wire(tmp_path):
    """A JAX-package server (its PKI, store and serde) feeds a port NetAgent
    over mutual TLS: the frames and certificates are the same."""
    from antrea_tpu.apis import controlplane as jcp
    from antrea_tpu.apis import crd as jcrd

    certdir = _pki(tmp_path, mod=jnet)
    ctl = JController()
    store = JStore()
    ctl.subscribe(store.apply)
    srv = jnet.DisseminationServer(store, certdir)
    try:
        _populate(ctl, jcrd)
        a = tnet.NetAgent("n1", srv.address, certdir,
                          TpuflowDatapath(device="cpu", **ENGINE_KW))
        srv.wait_connected(1)
        ctl.upsert_antrea_policy(_policy(api=jcrd, dcp=jcp))
        _until(srv, {"n1": a}, ["P"])
        _, got = _verdicts(a.agent.datapath, [("192.0.2.7", "10.0.1.1"),
                                              ("10.0.2.1", "10.0.1.1")], 1)
        assert got == [ACT_DROP, ACT_ALLOW]
        a.close()
    finally:
        srv.close()


def _k8s_policy():
    return crd.K8sNetworkPolicy(
        uid="np-web", name="np-web", namespace="default",
        pod_selector=crd.LabelSelector.make({"app": "web"}),
        ingress=[crd.K8sNPRule(
            peers=[crd.K8sPeer(pod_selector=crd.LabelSelector.make(
                {"app": "client"}))],
            ports=[crd.PortSpec(protocol=6, port=80)])])


def test_subprocess_agent_equals_the_in_process_agent():
    """agent_proc --datapath tpuflow --device cpu, spawned from the port's
    module, against an in-process agent and engine fed the same store:
    every reply field equal through install and a membership delta; then
    a kill surfaces as AgentDiedError."""
    ctl = NetworkPolicyController()
    store = RamStore()
    ctl.subscribe(store.apply)
    dp = TpuflowDatapath(device="cpu", miss_chunk=32, flow_slots=1 << 10,
                         aff_slots=1 << 8)
    local = AgentPolicyController("n1", dp, store)
    sub = SubprocessAgent("n1", store, datapath_type="tpuflow",
                          flow_slots=1 << 10, aff_slots=1 << 8,
                          device="cpu")
    try:
        argv = sub._proc.args
        assert argv[1:3] == ["-m",
                             "antrea_tpu_torch.dissemination.agent_proc"]
        assert argv[argv.index("--device") + 1] == "cpu"
        _populate(ctl)
        ctl.upsert_pod(crd.Pod(namespace="default", name="cli", ip="10.0.2.9",
                               node="n2", labels={"app": "client"}))
        ctl.upsert_k8s_policy(_k8s_policy())
        ips = ["10.0.1.1", "10.0.2.1", "10.0.2.9", "10.0.2.10", "10.0.7.7"]
        pkts = [Packet(src_ip=iputil.ip_to_u32(s),
                       dst_ip=iputil.ip_to_u32(d), proto=6,
                       src_port=30000 + i, dst_port=80)
                for i, (s, d) in enumerate((s, d) for s in ips for d in ips
                                           if s != d)]
        batch = PacketBatch.from_packets(pkts)
        for now, churn in ((10, None), (20, "10.0.2.10")):
            if churn:
                ctl.upsert_pod(crd.Pod(namespace="default", name="cli2",
                                       ip=churn, node="n2",
                                       labels={"app": "client"}))
                assert local._deltas  # a membership delta, no bundle
            assert sub.pump() > 0
            reply = sub.sync()
            local.sync()
            assert reply["generation"] == dp.generation
            assert reply["realized"] == local.realized_generations()
            assert local.sync_failures_total == 0
            got, want = sub.step(batch, now), dp.step(batch, now)
            for f in ("code", "est", "reply", "reject_kind", "snat",
                      "svc_idx", "dnat_ip", "dnat_port"):
                assert got[f] == [int(x) for x in getattr(want, f)], f
            assert got["ingress_rule"] == want.ingress_rule
            assert got["egress_rule"] == want.egress_rule
        assert dp._n_deltas > 0
        assert set(got["code"]) == {0, 1}
        assert sub.state_summary()["policies"] == ["np-web"]
        assert sub._stderr_tail() == ""
        # A malformed event is logged on the child's stderr (it keeps
        # serving), and the tail rides the typed death.
        sub._send_frame({"ev": {"malformed": True}})
        sub.sync()
        sub._proc.kill()
        sub._proc.wait(timeout=10)
        with pytest.raises(AgentDiedError) as ei:
            sub.sync()
        assert ei.value.node == "n1" and ei.value.exit_code == -9
        assert "event failed" in ei.value.stderr_tail
    finally:
        sub.stop()
