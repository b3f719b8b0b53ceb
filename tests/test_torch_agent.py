"""The PyTorch port's agent (antrea_tpu_torch/agent/controller.py) driving
the port's engine on the CPU, held to the JAX package's
AgentPolicyController driving the JAX TpuflowDatapath, both fed the same
watch events: a JAX NetworkPolicyController on a 3-node world publishes
them, each event crosses the wire format once (the JAX encoder) and is
decoded by each package's serde into its own RamStore, whose span filter
hands nodeA's share to that package's agent.

The walk (run once per module, recorded): install, pod churn (membership
deltas that must reach apply_group_delta, never a bundle), a span change,
a resync window that drops one policy (its retraction), and a poison
bundle (a capacity rejection both packages quarantine as permanent).
After every sync the two agents' counters and generations agree, and a
batch of fresh flows plus the earlier flows gives equal code, rule ids,
DNAT, est and dump_flows().  The retraction is also held to a fresh port
engine built on the smaller PolicySet.  The agents' filestores load across
packages both ways, compile to equal tables and drive equal engines."""

import copy
import dataclasses

import numpy as np
import pytest

from antrea_tpu.agent import AgentPolicyController as JAgent
from antrea_tpu.apis import crd as jcrd
from antrea_tpu.apis.controlplane import Direction, RuleAction
from antrea_tpu.apis.service import Endpoint as JEndpoint
from antrea_tpu.apis.service import ServiceEntry as JServiceEntry
from antrea_tpu.compiler.compile import compile_policy_set as jcompile
from antrea_tpu.controller import NetworkPolicyController as JController
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.dissemination import RamStore as JStore
from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.packet import PacketBatch as JBatch
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import agent as tagent
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.compiler.compile import compile_policy_set as tcompile
from antrea_tpu_torch.dissemination import RamStore as TStore
from antrea_tpu_torch.dissemination import serde as tserde
from antrea_tpu_torch.models import pipeline as tpl

from test_torch_engine import diff, port_svcs, tb
import torch_cpu  # noqa: F401  (one torch thread a worker)

NODE = "nodeA"
KW = dict(flow_slots=1 << 10, aff_slots=1 << 8, miss_chunk=32,
          delta_slots=32, canary_probes=0)
# The port's engine certifies each install and delta with its canary (the
# JAX canary's eager walk would cost this file ten seconds; its verdicts
# are the same either way).
TKW = {**KW, "canary_probes": 4}
IPS = ["10.0.0.10", "10.0.0.11", "10.0.0.20", "10.0.0.21", "10.0.0.30",
       "10.0.5.5", "10.96.0.1"]
# A rule count the walk's policies never reach at install and the poison
# stage's policy passes: the capacity bound both packages' make_pipeline
# checks, lowered for the poison stage only.
POISON_RULES = 3


def _pod(name, ip, node, **labels):
    return jcrd.Pod(namespace="default", name=name, ip=ip, node=node,
                    labels=labels)


def _np_web():
    return jcrd.K8sNetworkPolicy(
        uid="np-web", namespace="default", name="np-web",
        pod_selector=jcrd.LabelSelector.make({"app": "web"}),
        policy_types=[Direction.IN],
        ingress=[jcrd.K8sNPRule(
            peers=[jcrd.K8sPeer(pod_selector=jcrd.LabelSelector.make(
                {"app": "client"}))],
            ports=[jcrd.PortSpec(protocol=6, port=80),
                   jcrd.PortSpec(protocol=6, port=8080)])])


def _acnp(uid, peer_app, action=RuleAction.DROP, n_rules=1):
    return jcrd.AntreaNetworkPolicy(
        uid=uid, name=uid, tier_priority=250, priority=1.0,
        applied_to=[jcrd.AntreaAppliedTo(
            pod_selector=jcrd.LabelSelector.make({"app": "web"}))],
        rules=[jcrd.AntreaNPRule(
            direction=Direction.IN, action=action,
            peers=[jcrd.AntreaPeer(pod_selector=jcrd.LabelSelector.make(
                {"app": peer_app}))],
            ports=[jcrd.PortSpec(protocol=6, port=1000 + i)])
            for i in range(n_rules)])


def _services():
    return [JServiceEntry(cluster_ip="10.96.0.1", port=80, protocol=6,
                          endpoints=[JEndpoint("10.0.0.10", 8080, "nodeA"),
                                     JEndpoint("10.0.0.11", 8080, "nodeB")],
                          name="web", namespace="default")]


def _batch(sport):
    """Every ordered pair of IPS on ports 80, 8080 and 1000, each flow at
    its own source port from `sport` on (fresh 5-tuples)."""
    rows = [(s, d, p) for s in IPS for d in IPS if s != d
            for p in (80, 8080, 1000)]
    return JBatch(
        src_ip=np.array([iputil.ip_to_u32(s) for s, _, _ in rows], np.uint32),
        dst_ip=np.array([iputil.ip_to_u32(d) for _, d, _ in rows], np.uint32),
        proto=np.full(len(rows), 6, np.int32),
        src_port=np.arange(sport, sport + len(rows), dtype=np.int32),
        dst_port=np.array([p for _, _, p in rows], np.int32))


class Side:
    """One package's store, engine and agent, with the engine's
    install_bundle / apply_group_delta calls counted."""

    def __init__(self, store_cls, engine, agent_cls, serde_mod, filestore):
        self.store = store_cls()
        self.serde = serde_mod
        self.dp = engine
        self.calls = {"install_bundle": 0, "apply_group_delta": 0}
        for name in self.calls:
            real = getattr(engine, name)

            def counted(*a, _real=real, _name=name, **k):
                self.calls[_name] += 1
                return _real(*a, **k)

            setattr(engine, name, counted)
        self.agent = agent_cls(NODE, engine, self.store,
                               filestore_dir=filestore)

    def publish(self, wire_events):
        for w in wire_events:
            self.store.apply(self.serde.decode_event(w))

    def snapshot(self):
        return {k: v for k, v in self.calls.items()}


def _sync_both(j, t, what):
    for side in (j, t):
        side.agent.sync()
    for k in ("sync_failures_total", "last_sync_error", "permanent_failure",
              "realization_stamps_dropped_total"):
        assert getattr(j.agent, k) == getattr(t.agent, k), (what, k)
    assert j.dp.generation == t.dp.generation, what
    assert j.agent.realized_generations() == t.agent.realized_generations()
    assert (jserde.encode_policy_set(j.agent.policy_set)
            == tserde.encode_policy_set(t.agent.policy_set)), what


def _step_both(j, t, b, now, what):
    rj, rt = j.dp.step(b, now), t.dp.step(tb(b), now)
    diff(rj, rt, what)
    assert j.dp.dump_flows(now) == t.dp.dump_flows(now), what
    return rt


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """The recorded walk: {stage: facts}, plus both sides."""
    jdir = str(tmp_path_factory.mktemp("jfs"))
    tdir = str(tmp_path_factory.mktemp("tfs"))
    svcs = _services()
    j = Side(JStore, JEngine(None, copy.deepcopy(svcs), **KW), JAgent,
             jserde, jdir)
    t = Side(TStore, td.TpuflowDatapath(None, port_svcs(svcs), device="cpu",
                                        **TKW),
             tagent.AgentPolicyController, tserde, tdir)
    ctl = JController()
    events = []
    ctl.subscribe(lambda ev: events.append(jserde.encode_event(ev)))

    def publish():
        out = list(events)
        events.clear()
        j.publish(out)
        t.publish(out)
        return out

    rec = {}
    sport = iter(range(20000, 60000, 500))
    now = iter(range(10, 1000, 10))
    old = []  # every batch stepped so far, stepped again each stage

    def stage(name, **facts):
        b = _batch(next(sport))
        n = next(now)
        for k, ob in enumerate(old):
            _step_both(j, t, ob, n, f"{name}: earlier batch {k}")
        r = _step_both(j, t, b, n, name)
        old.append(b)
        rec[name] = dict(facts, result=r, batch=b, now=n,
                         generation=t.dp.generation, calls=t.snapshot(),
                         jcalls=j.snapshot())

    # 1. Install: pods on three nodes, a K8s policy and an ACNP, one of
    # whose peers is nodeC's.
    ctl.upsert_namespace(jcrd.Namespace("default", {}))
    for pod in (_pod("web1", "10.0.0.10", "nodeA", app="web"),
                _pod("web2", "10.0.0.11", "nodeB", app="web"),
                _pod("cli1", "10.0.0.20", "nodeB", app="client"),
                _pod("db1", "10.0.0.30", "nodeC", app="db")):
        ctl.upsert_pod(pod)
    ctl.upsert_k8s_policy(_np_web())
    ctl.upsert_antrea_policy(_acnp("acnp-db", "db"))
    n_install = len(publish())
    _sync_both(j, t, "install")
    stage("install", events=n_install)

    # 2. Pod churn: a client joins on nodeC, cli1 leaves: nodeA holds both
    # groups, so each is a membership delta on the address group.
    inc0 = t.dp._drs.ingress.at.inc
    ctl.upsert_pod(_pod("cli2", "10.0.0.21", "nodeC", app="client"))
    ctl.delete_pod("default/cli1")
    deltas = publish()
    pending = list(t.agent._deltas)
    _sync_both(j, t, "deltas")
    stage("deltas", events=len(deltas), pending=pending,
          n_deltas=t.dp._n_deltas, same_tables=t.dp._drs.ingress.at.inc
          is inc0, jn_deltas=j.dp._n_deltas)

    # 3. A span change that nodeA holds: a second web pod lands on nodeA.
    ctl.upsert_pod(_pod("web3", "10.0.5.5", "nodeA", app="web"))
    publish()
    _sync_both(j, t, "span")
    stage("span")

    # 4. A resync window that drops the ACNP: the re-list replays nodeA's
    # whole snapshot but that policy, the agent retracts it at the end.
    w = j.store.watch_queue(NODE, replay=False)
    snap = [jserde.encode_event(ev) for ev in j.store.resync(w)]
    w.stop()
    kept = [w for w in snap if w["name"] != "acnp-db"]
    for side in (j, t):
        side.agent.begin_resync()
        for w in kept:
            side.agent.handle_event(side.serde.decode_event(w))
        side.agent.end_resync()
    _sync_both(j, t, "resync")
    stage("resync", dropped=len(snap) - len(kept),
          policies=sorted(p.uid for p in t.agent.policy_set.policies))
    fresh = td.TpuflowDatapath(copy.deepcopy(t.agent.policy_set),
                               port_svcs(svcs), device="cpu", **KW)
    rec["resync"]["fresh"] = fresh.step(tb(rec["resync"]["batch"]),
                                        rec["resync"]["now"])

    # 5. A poison bundle: with the capacity bound lowered, an ACNP of more
    # rules than it is a deterministic compile rejection in both packages.
    gen = t.dp.generation
    real = (jpl.check_rule_capacity, tpl.check_rule_capacity)

    def lowered(mod):
        def check(cps):
            for dt in (cps.ingress, cps.egress):
                if dt.n_rules > POISON_RULES + 1:
                    raise mod.PolicyCapacityError(
                        f"flow-cache rule packing supports {POISON_RULES} "
                        f"rules here, got {dt.n_rules}")
        return check

    jpl.check_rule_capacity, tpl.check_rule_capacity = (lowered(jpl),
                                                        lowered(tpl))
    try:
        ctl.upsert_antrea_policy(_acnp("acnp-big", "client",
                                       RuleAction.ALLOW, POISON_RULES + 4))
        publish()
        for side in (j, t):
            side.agent.sync()
            side.agent.sync()  # quarantined: no second attempt
    finally:
        jpl.check_rule_capacity, tpl.check_rule_capacity = real
    rec["poison"] = dict(
        failures=(j.agent.sync_failures_total, t.agent.sync_failures_total),
        permanent=(j.agent.permanent_failure, t.agent.permanent_failure),
        last=(j.agent.last_sync_error, t.agent.last_sync_error),
        generation=(gen, j.dp.generation, t.dp.generation),
        calls=(j.snapshot(), t.snapshot()))
    # New upstream state lifts the quarantine; the bound is back, so the
    # bundle installs.
    ctl.delete_policy("acnp-big")
    publish()
    j.agent.sync()
    t.agent.sync()
    rec["recovered"] = dict(
        permanent=(j.agent.permanent_failure, t.agent.permanent_failure),
        generation=(j.dp.generation, t.dp.generation))
    rec["dirs"] = (jdir, tdir)
    rec["sides"] = (j, t)
    rec["svcs"] = svcs
    return rec


def test_agents_hold_the_same_state_after_every_sync(walk):
    """The walk itself compares both agents and engines at every stage;
    here the stages' facts."""
    assert walk["install"]["events"] > 0
    assert walk["install"]["generation"] == 1
    r = walk["install"]["result"]
    assert set(np.unique(r.code)) >= {0, 1}
    assert (r.svc_idx >= 0).any()  # the Service's DNAT is on the path
    j, t = walk["sides"]
    assert [p.uid for p in t.agent.policy_set.policies] == ["np-web"]
    assert t.agent.sync_failures_total == 1  # the poison stage's one
    # Every install and delta went through the port's canary.
    st = t.dp.commit_stats()
    assert st["canary_probes_total"] > 0 and not st["degraded"]


def test_membership_deltas_reach_apply_group_delta(walk):
    st = walk["deltas"]
    assert {name for name, _a, _r in st["pending"]}, st
    before = walk["install"]["calls"]
    assert st["calls"]["install_bundle"] == before["install_bundle"]
    assert (st["calls"]["apply_group_delta"] - before["apply_group_delta"]
            == len(st["pending"]))
    assert st["jcalls"] == st["calls"]
    assert st["same_tables"] and st["n_deltas"] == st["jn_deltas"] > 0
    # Each delta is a commit of its own (a generation), never a bundle.
    assert (st["generation"] - walk["install"]["generation"]
            == len(st["pending"]))


def test_resync_retracts_the_dropped_policy(walk):
    st = walk["resync"]
    assert st["dropped"] == 1 and st["policies"] == ["np-web"]
    assert st["generation"] == walk["span"]["generation"] + 1
    # The fresh-flow batch after the retraction equals an engine built on
    # the smaller set from nothing.
    got, want = st["result"], st["fresh"]
    for f in ("code", "svc_idx", "dnat_ip", "dnat_port"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.ingress_rule == want.ingress_rule
    assert got.egress_rule == want.egress_rule
    # The ACNP dropped db1 -> web1 on port 1000 before, not after.
    assert (walk["install"]["result"].code
            != st["result"].code).any()


def test_poison_bundle_is_quarantined_alike(walk):
    p = walk["poison"]
    gen = p["generation"][0]
    assert p["generation"] == (gen, gen, gen)  # nothing installed
    assert p["failures"] == (1, 1)
    jperm, tperm = p["permanent"]
    assert tperm == jperm and tperm.startswith("PolicyCapacityError: ")
    assert p["last"][0] == p["last"][1] != ""
    jc, tc = p["calls"]
    assert jc == tc
    assert walk["recovered"]["permanent"] == ("", "")
    g = walk["recovered"]["generation"]
    assert g[0] == g[1] == gen + 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_filestore_crosses_packages(walk, direction):
    """An agent restarted without a store enforces its filestore's state:
    the JAX agent's file (serde JSON, atomic_write_json) loads into the
    port's agent and the port's into the JAX agent; the PolicySets compile
    to equal tables and drive equal engines."""
    jdir, tdir = walk["dirs"]
    svcs = walk["svcs"]
    src = jdir if direction == "jax_to_port" else tdir
    ja = JAgent(NODE, JEngine(None, copy.deepcopy(svcs), **KW),
                filestore_dir=src)
    ta = tagent.AgentPolicyController(
        NODE, td.TpuflowDatapath(None, port_svcs(svcs), device="cpu", **KW),
        filestore_dir=src)
    j, t = walk["sides"]
    want = tserde.encode_policy_set(t.agent.policy_set)
    assert tserde.encode_policy_set(ta.policy_set) == want
    assert jserde.encode_policy_set(ja.policy_set) == want
    jc, tc = jcompile(ja.policy_set), tcompile(ta.policy_set)
    assert jc.ingress.n_rules > 0
    for d in ("ingress", "egress"):
        jt, tt = getattr(jc, d), getattr(tc, d)
        for f in dataclasses.fields(jt):
            a, b = getattr(jt, f.name), getattr(tt, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f"{d}.{f.name}")
            else:
                assert a == b, (d, f.name)
    for f in ("iso_in_gid", "iso_out_gid", "n_ip_groups", "n_svc_groups",
              "ip_groups", "svc_groups", "ag_gids", "gid_ident",
              "has_svcref"):
        assert getattr(jc, f) == getattr(tc, f), f
    ja.sync()
    ta.sync()
    assert ja.datapath.generation == ta.datapath.generation == 1
    b = walk["resync"]["batch"]
    diff(ja.datapath.step(b, 5), ta.datapath.step(tb(b), 5), direction)


def test_policy_bookkeeping_equals_the_jax_agent():
    """The port's agent keeps its policies through a uid index where the
    JAX agent rescans its list on every event: on a seeded stream of
    adds, re-adds, span-only and spec updates, deletes (known and not),
    group events and re-list windows (whose retraction replaces the
    list), both agents hold the same PolicySet after every event, policy
    order included, with the same pending deltas and dirty flag."""
    from antrea_tpu.apis import controlplane as jcp
    from antrea_tpu.controller.networkpolicy import WatchEvent as JEvent

    rng = np.random.default_rng(13)
    agents = (JAgent("n", None), tagent.AgentPolicyController("n", None))

    def pol(i, gen):
        return jcp.NetworkPolicy(
            uid=f"p{i}", name=f"p{i}", type=jcp.NetworkPolicyType.ACNP,
            applied_to_groups=[f"atg{i % 3}"], rules=[],
            tier_priority=250, priority=float(i), generation=gen)

    def member(k):
        return jcp.GroupMember(ip=f"10.1.0.{k}", node="n")

    def feed(ev):
        w = jserde.encode_event(ev)
        for a, mod in zip(agents, (jserde, tserde)):
            a.handle_event(mod.decode_event(w))
        j, t = agents
        assert (jserde.encode_policy_set(j.policy_set)
                == tserde.encode_policy_set(t.policy_set)), w
        assert j._rules_dirty == t._rules_dirty and j._deltas == t._deltas

    for step in range(400):
        i = int(rng.integers(0, 24))
        r = rng.random()
        if r < 0.45:
            kind = "ADDED" if rng.random() < 0.5 else "UPDATED"
            feed(JEvent(kind=kind, obj_type="NetworkPolicy", name=f"p{i}",
                        obj=pol(i, step), span={"n"},
                        span_only=bool(rng.random() < 0.3)))
        elif r < 0.6:
            feed(JEvent(kind="DELETED", obj_type="NetworkPolicy",
                        name=f"p{i}"))
        elif r < 0.8:
            g = f"ag{i % 4}"
            feed(JEvent(kind="UPDATED", obj_type="AddressGroup", name=g,
                        obj=jcp.AddressGroup(g, [member(i)]), span={"n"},
                        added=[member(step % 200)]))
        elif r < 0.97:
            for a in agents:
                a._rules_dirty = False
                a._deltas.clear()
        else:
            # A re-list window of a random subset of the policies held.
            keep = sorted(p.uid for p in agents[1].policy_set.policies
                          if rng.random() < 0.6)
            for a in agents:
                a.begin_resync()
            for uid in keep:
                feed(JEvent(kind="ADDED", obj_type="NetworkPolicy",
                            name=uid, obj=pol(int(uid[1:]), step),
                            span={"n"}))
            for a in agents:
                a.end_resync()
            assert ([p.uid for p in agents[0].policy_set.policies]
                    == [p.uid for p in agents[1].policy_set.policies])
    assert len(agents[1].policy_set.policies) > 5
