"""The PyTorch port's fleet simulator and status plane on the CPU, held to
the JAX package's: the controller's span-filtered fan-out to watch-only fake
agents, the StatusAggregator's phases, the churn storm's meters, and over
mutual TLS a fleet around node-0's NetAgent driving the port's engine, read
back through antctl against the port's ControllerApiServer.

(i) and (ii) feed the two packages' controllers the same seeded operations
and compare what each fleet holds node by node; the fake agents never touch
an engine, so the comparison is of tables, generations and statuses."""

import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np

from antrea_tpu.apis import controlplane as jcp
from antrea_tpu.apis import crd as jcrd
from antrea_tpu.controller import NetworkPolicyController as JController
from antrea_tpu.controller.status import StatusAggregator as JAggregator
from antrea_tpu.dissemination import RamStore as JStore
from antrea_tpu.simulator import fleet as jfleet
from antrea_tpu_torch.apis import controlplane as tcp
from antrea_tpu_torch.apis import crd as tcrd
from antrea_tpu_torch.controller import NetworkPolicyController as TController
from antrea_tpu_torch.controller.apiserver import ControllerApiServer
from antrea_tpu_torch.controller.status import PHASE_REALIZED
from antrea_tpu_torch.controller.status import StatusAggregator as TAggregator
from antrea_tpu_torch.dissemination import RamStore as TStore
from antrea_tpu_torch.oracle import Oracle
from antrea_tpu_torch.simulator import fleet as tfleet

import torch_fleet_world as tfw
import torch_cpu  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parent.parent
N_NODES = 16
NODES = [f"node-{n}" for n in range(N_NODES)]
JAX = (JController, JStore, JAggregator, jfleet, jcrd, jcp)
PORT = (TController, TStore, TAggregator, tfleet, tcrd, tcp)


def _ops(seed, n=60):
    """A seeded stream of controller operations, package-neutral: the two
    namespaces, two pods a node (tier even / odd by node, a random app),
    then upserts of ACNPs on the even, the odd or all nodes' pods and of
    K8s NetworkPolicies, pod relabels and deletions, policy deletions."""
    rng = random.Random(seed)
    ops = [("ns", "default"), ("ns", "other")]
    pods = {}
    for k in range(N_NODES):
        for p in range(2):
            key = (rng.choice(["default", "other"]), f"p-{k}-{p}")
            pods[key] = (f"10.8.{k}.{p + 1}", f"node-{k}",
                         "even" if k % 2 == 0 else "odd")
            ops.append(("pod", *key, *pods[key],
                        rng.choice(["web", "db", "cli"])))
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            ops.append(("acnp", f"acnp-{rng.randrange(8)}",
                        rng.choice(["even", "odd", None]),
                        rng.choice(["web", "db", "cli"]),
                        rng.randrange(1, 20), rng.random() < 0.5))
        elif r < 0.55:
            ops.append(("k8s", f"np-{rng.randrange(6)}",
                        rng.choice(["default", "other"]),
                        rng.choice(["web", "db", "cli"]),
                        rng.choice(["web", "db", "cli"]),
                        rng.choice([80, 443])))
        elif r < 0.75:
            key = rng.choice(sorted(pods))
            ops.append(("pod", *key, *pods[key],
                        rng.choice(["web", "db", "cli"])))
        elif r < 0.85:
            key = rng.choice(sorted(pods))
            ops.append(("delpod", *key))
        else:
            ops.append(("del", rng.choice(
                [f"acnp-{i}" for i in range(8)] + [f"np-{i}"
                                                   for i in range(6)])))
    return ops


def _apply(op, ctl, crd, cp):
    sel = crd.LabelSelector.make
    kind = op[0]
    if kind == "ns":
        ctl.upsert_namespace(crd.Namespace(name=op[1], labels={"n": op[1]}))
    elif kind == "pod":
        _, ns, name, ip, node, tier, app = op
        ctl.upsert_pod(crd.Pod(namespace=ns, name=name, ip=ip, node=node,
                               labels={"tier": tier, "app": app}))
    elif kind == "delpod":
        ctl.delete_pod(f"{op[1]}/{op[2]}")
    elif kind == "acnp":
        _, uid, tier, peer, prio, drop = op
        ctl.upsert_antrea_policy(crd.AntreaNetworkPolicy(
            uid=uid, name=uid, namespace="", tier_priority=250,
            priority=prio,
            applied_to=[crd.AntreaAppliedTo(
                pod_selector=sel({"tier": tier} if tier else {}),
                ns_selector=sel())],
            rules=[crd.AntreaNPRule(
                direction=cp.Direction.IN,
                action=cp.RuleAction.DROP if drop else cp.RuleAction.ALLOW,
                peers=[crd.AntreaPeer(pod_selector=sel({"app": peer}),
                                      ns_selector=sel())])]))
    elif kind == "k8s":
        _, uid, ns, app, peer, port = op
        ctl.upsert_k8s_policy(crd.K8sNetworkPolicy(
            uid=uid, name=uid, namespace=ns, pod_selector=sel({"app": app}),
            ingress=[crd.K8sNPRule(
                peers=[crd.K8sPeer(pod_selector=sel({"app": peer}))],
                ports=[crd.PortSpec(protocol=6, port=port)])]))
    else:
        ctl.delete_policy(op[1])


def _inproc(pkg, **kw):
    Controller, Store, Aggregator, fleet, _, _ = pkg
    ctl, store = Controller(), Store()
    ctl.subscribe(store.apply)
    agg = Aggregator(ctl)
    fl = fleet.FakeAgentFleet(store, NODES,
                              status_reporter=agg.make_agent_reporter(), **kw)
    return ctl, agg, fl


def _held(ctl, fl):
    """Per node: the agent's policy uids with their generations, its group
    names and its event count.  The policies equal the controller's span
    for the node.  The groups hold the span's, and may hold more: the
    controller re-emits a shared group's span when a policy referencing it
    is installed, not when one is deleted or stops referencing it
    (networkpolicy.py's delete_policy and _install unref the group and
    retract it only with its last reference), so a node whose last policy
    on a shared group went keeps that group.  Each such extra must be a
    live group of the controller that no policy of the node's span
    references.  -> ({node: what it holds}, extras seen)."""
    out, extras = {}, 0
    live = ctl.policy_set()
    for node in NODES:
        a = fl.agents[node]
        got = ({u: p.generation for u, p in a.policies.items()},
               sorted(a.address_groups), sorted(a.applied_to_groups),
               a.events_seen)
        want = ctl.policy_set_for_node(node)
        assert got[0] == {p.uid: p.generation for p in want.policies}, node
        for part, names in (("address_groups", got[1]),
                            ("applied_to_groups", got[2])):
            span = set(getattr(want, part))
            assert span <= set(names), (node, part)
            extra = set(names) - span
            assert extra <= set(getattr(live, part)), (node, part, extra)
            extras += len(extra)
        out[node] = got
    return out, extras


def test_fan_out_and_statuses_equal_the_jax_fleet():
    """(i) The same seeded operations through each package's controller,
    RamStore and inproc fleet, pumped every 6 operations: per node the
    agents' uids, generations, group names and event counts equal across
    the packages, the policies equal to policy_set_for_node and the groups
    to it but for the shared groups both controllers leave behind (_held);
    the two aggregators' statuses equal field for field."""
    worlds = [_inproc(pkg) for pkg in (JAX, PORT)]
    ops = _ops(5)
    spans, extras = set(), 0
    for k, op in enumerate(ops):
        for (ctl, _, _), pkg in zip(worlds, (JAX, PORT)):
            _apply(op, ctl, pkg[4], pkg[5])
        if k % 6 == 5 or k == len(ops) - 1:
            held = []
            for ctl, agg, fl in worlds:
                fl.pump()
                held.append(_held(ctl, fl))
            assert held[0] == held[1], k
            extras += held[1][1]
            st = [[dataclasses.asdict(s) for s in agg.all_statuses()]
                  for _, agg, _ in worlds]
            assert st[0] == st[1], k
            assert all(s["phase"] == PHASE_REALIZED for s in st[1])
            spans |= {len(pols) for pols, *_ in held[1][0].values()}
    assert len(spans) > 2  # the spans really differ from node to node
    assert extras > 0  # the stream reaches the left-behind groups
    for _, _, fl in worlds:
        fl.stop()


def _storm_world(pkg, cap):
    ctl, agg, fl = _inproc(pkg, max_pending=cap)
    crd = pkg[4]
    ctl.upsert_namespace(crd.Namespace(name="bench", labels={"team": "t0"}))
    for i, node in enumerate(NODES):
        ctl.upsert_pod(crd.Pod(name=f"pod-{i}", namespace="bench",
                               labels={"app": "web"}, ip=f"10.0.{i}.1",
                               node=node))
    return ctl, agg, fl


def test_churn_storm_meters_equal_the_jax_fleet():
    """(ii) run_churn_storm on both packages' inproc fleets, 16 agents,
    cap 8, churn 12 (so every round overflows every watcher), 2 rounds: the
    meters equal but for realization_p99_s, which reads the clock; the
    statuses equal and Realized."""
    meters, statuses = [], []
    for pkg in (JAX, PORT):
        ctl, agg, fl = _storm_world(pkg, 8)
        fl.pump()
        m = pkg[3].run_churn_storm(ctl, fl, NODES, rounds=2, churn=12,
                                   cap=8)
        m.pop("realization_p99_s")
        meters.append(m)
        statuses.append([dataclasses.asdict(s) for s in agg.all_statuses()])
        fl.stop()
    assert meters[0] == meters[1]
    assert meters[1]["overflows_total"] > 0
    assert meters[1]["resyncs_total"] > 0
    assert statuses[0] == statuses[1]
    assert {s["phase"] for s in statuses[1]} == {PHASE_REALIZED}


def test_tls_fleet_around_node0_agent(tmp_path):
    """(iii) 8 port NetFakeAgents and node-0's port NetAgent (its engine on
    the CPU) over mutual TLS: the fan-out is span-filtered, every policy is
    Realized with current == desired, node-0's engine equals the scalar
    Oracle on its span, and the port's antctl get policystatus reads the
    same statuses from the port's ControllerApiServer."""
    with tfw.tls_fleet(str(tmp_path / "pki"), "cpu") as f:
        for pol in tfw.policies():
            tfw.install(f.ctl, pol)
        f.converge()
        for n, node in enumerate(f.nodes):
            want = {"np-web", "acnp-even" if n % 2 == 0 else "acnp-odd"}
            got = (f.fleet.policies_on(node) if n else
                   {p.uid for p in f.na.agent.policy_set.policies})
            assert got == want, node
        statuses = f.agg.all_statuses()
        assert [(s.uid, s.phase, s.current_nodes, s.desired_nodes)
                for s in statuses] == [
            ("acnp-even", PHASE_REALIZED, 5, 5),
            ("acnp-odd", PHASE_REALIZED, 4, 4),
            ("np-web", PHASE_REALIZED, 9, 9)]
        b = tfw.node0_lanes(20000)
        r = f.engine.step(b, 10)
        o = Oracle(f.ctl.policy_set_for_node(tfw.NODE0))
        want = [int(o.classify(b.packet(i)).code) for i in range(b.size)]
        assert np.asarray(r.code).tolist() == want
        assert 0 < sum(want) < len(want)
        api = ControllerApiServer(f.ctl, store=f.store, status=f.agg).start()
        try:
            out = subprocess.run(
                [sys.executable, "-m", "antrea_tpu_torch.antctl", "get",
                 "policystatus", "--server",
                 f"http://127.0.0.1:{api.address[1]}"],
                capture_output=True, text=True, timeout=120, check=True,
                cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
        finally:
            api.stop()
        rows = json.loads(out.stdout)["items"]
        assert [(r["uid"], r["phase"], r["currentNodesRealized"],
                 r["desiredNodesRealized"]) for r in rows] == [
            (s.uid, s.phase, s.current_nodes, s.desired_nodes)
            for s in statuses]
