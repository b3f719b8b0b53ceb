"""The PyTorch port's fleet over mutual TLS, for tests/test_torch_fleet.py
and the gpu test in tests/test_torch_cuda.py: a controller over pods on
node-0 .. node-N, a DisseminationServer with a StatusAggregator, N
NetFakeAgents (node-1 .. node-N) and node-0's NetAgent driving the port's
engine on a given device.  It imports the PyTorch port and nothing of jax,
so that the card's machine, which has no jax, can run it."""

import contextlib

import numpy as np

from antrea_tpu_torch.apis import controlplane as cp
from antrea_tpu_torch.apis import crd
from antrea_tpu_torch.controller import NetworkPolicyController
from antrea_tpu_torch.controller.status import StatusAggregator
from antrea_tpu_torch.datapath import TpuflowDatapath
from antrea_tpu_torch.dissemination import RamStore
from antrea_tpu_torch.dissemination.netwire import (DisseminationServer,
                                                     NetAgent, make_ca)
from antrea_tpu_torch.packet import PacketBatch
from antrea_tpu_torch.simulator.fleet import FakeAgentFleet, fleet_converged
from antrea_tpu_torch.utils import ip as iputil

N_FAKE = 8
NODE0 = "node-0"
ENGINE_KW = dict(flow_slots=1 << 10, aff_slots=1 << 8, miss_chunk=32,
                 canary_probes=4, fused=True, prune_budget=2)


def pod_ip(n: int, p: int) -> str:
    return f"10.9.{n}.{p + 1}"


def populate(ctl, n_nodes):
    """Two pods a node (app=web and app=cli), tier even / odd by node."""
    ctl.upsert_namespace(crd.Namespace(name="default", labels={}))
    for n in range(n_nodes):
        for p, app in enumerate(("web", "cli")):
            ctl.upsert_pod(crd.Pod(
                namespace="default", name=f"{app}-{n}", ip=pod_ip(n, p),
                node=f"node-{n}",
                labels={"app": app,
                        "tier": "even" if n % 2 == 0 else "odd"}))


def policies():
    """An ACNP on the even nodes' pods, one on the odd nodes' and a K8s
    NetworkPolicy on every web pod."""
    sel = crd.LabelSelector.make
    out = []
    for uid, tier, cidr in (("acnp-even", "even", "192.0.2.0/24"),
                            ("acnp-odd", "odd", "198.51.100.0/24")):
        out.append(crd.AntreaNetworkPolicy(
            uid=uid, name=uid, namespace="", tier_priority=250, priority=1,
            applied_to=[crd.AntreaAppliedTo(pod_selector=sel({"tier": tier}),
                                            ns_selector=sel())],
            rules=[crd.AntreaNPRule(
                direction=cp.Direction.IN, action=cp.RuleAction.DROP,
                peers=[crd.AntreaPeer(ip_block=crd.IPBlock(cidr))])]))
    out.append(crd.K8sNetworkPolicy(
        uid="np-web", name="np-web", namespace="default",
        pod_selector=sel({"app": "web"}),
        ingress=[crd.K8sNPRule(
            peers=[crd.K8sPeer(pod_selector=sel({"app": "cli"}))],
            ports=[crd.PortSpec(protocol=6, port=80)])]))
    return out


def install(ctl, pol):
    if isinstance(pol, crd.K8sNetworkPolicy):
        ctl.upsert_k8s_policy(pol)
    else:
        ctl.upsert_antrea_policy(pol)


class TlsFleet:
    """The fleet, node-0's agent and the controller they follow."""

    def __init__(self, certdir, device, n_fake=N_FAKE):
        make_ca(certdir)
        self.nodes = [f"node-{n}" for n in range(n_fake + 1)]
        self.ctl = NetworkPolicyController()
        self.store = RamStore()
        self.ctl.subscribe(self.store.apply)
        self.agg = StatusAggregator(self.ctl)
        self.srv = DisseminationServer(self.store, certdir,
                                       status_aggregator=self.agg)
        self.fleet = self.na = None
        populate(self.ctl, len(self.nodes))
        self.fleet = FakeAgentFleet(None, self.nodes[1:], transport="netwire",
                                    server=self.srv, certdir=certdir)
        self.engine = TpuflowDatapath(device=device, **ENGINE_KW)
        self.na = NetAgent(NODE0, self.srv.address, certdir, self.engine)
        self.srv.wait_connected(len(self.nodes), timeout=30.0)

    def pump(self):
        self.fleet.pump()
        self.na.pump(wait=0.05)
        self.na.sync_and_report()
        a = self.na.agent
        assert a.sync_failures_total == 0, a.last_sync_error
        assert a.permanent_failure == ""
        self.srv.pump()  # node-0's status report

    def node0_holds_its_span(self) -> bool:
        want = self.ctl.policy_set_for_node(NODE0)
        got = self.na.agent.policy_set
        return ({p.uid: p.generation for p in got.policies}
                == {p.uid: p.generation for p in want.policies}
                and set(got.address_groups) == set(want.address_groups)
                and set(got.applied_to_groups) == set(want.applied_to_groups))

    def converge(self, rounds=60):
        for _ in range(rounds):
            self.pump()
            if (fleet_converged(self.ctl, self.fleet, self.nodes[1:])
                    and self.node0_holds_its_span()):
                self.pump()  # the statuses of the last syncs
                return
        raise AssertionError("the fleet did not converge")

    def close(self):
        if self.na is not None:
            self.na.close()
        if self.fleet is not None:
            self.fleet.stop()
        self.srv.close()


@contextlib.contextmanager
def tls_fleet(certdir, device, n_fake=N_FAKE):
    f = TlsFleet(certdir, device, n_fake)
    try:
        yield f
    finally:
        f.close()


def node0_lanes(sport):
    """TCP lanes toward node-0's pods from every pod of the fleet and from
    both ACNPs' blocks, to ports 80 and 443."""
    srcs = [pod_ip(n, p) for n in range(N_FAKE + 1) for p in (0, 1)]
    srcs += ["192.0.2.7", "198.51.100.9", "203.0.113.5"]
    rows = [(s, d, port) for s in srcs for d in (pod_ip(0, 0), pod_ip(0, 1))
            if s != d for port in (80, 443)]
    return PacketBatch(
        src_ip=np.array([iputil.ip_to_u32(s) for s, _, _ in rows], np.uint32),
        dst_ip=np.array([iputil.ip_to_u32(d) for _, d, _ in rows], np.uint32),
        proto=np.full(len(rows), 6, np.int32),
        src_port=np.arange(sport, sport + len(rows), dtype=np.int32),
        dst_port=np.array([p for _, _, p in rows], np.int32))


def walk(certdir, device):
    """node-0's engine through the fleet's life: the policies installed,
    then acnp-even deleted; two steps after each -> the step results."""
    out = []
    with tls_fleet(certdir, device) as f:
        for pol in policies():
            install(f.ctl, pol)
        f.converge()
        b = node0_lanes(20000)
        out += [f.engine.step(b, 10), f.engine.step(b, 11)]
        f.ctl.delete_policy("acnp-even")
        f.converge()
        b = node0_lanes(30000)
        out += [f.engine.step(b, 20), f.engine.step(b, 21)]
    return out
