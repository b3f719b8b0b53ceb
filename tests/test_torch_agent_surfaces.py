"""The agent's surfaces on the PyTorch port's live engine (on the CPU), each
held to the JAX package's on the JAX engine over the same world: the agent
API server's routes, live traceflow, the node-route controller's topology,
FQDN-learned membership (deltas and the maintenance task), packet capture,
agentinfo, the endpoint querier, the support bundle and antctl, live
against each package's API server and offline on a persist dir, which the
two packages share.

One world of a few pods on node n0 (an ACNP drop, a K8s isolation, an
FQDN egress drop and a Service), one JAX engine and one port engine built
once for the module, each tapped by its package's TraceflowController and
served by its package's AgentApiServer.  Every probe is a fresh 5-tuple."""

import copy
import itertools
import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest

from antrea_tpu import antctl as jantctl
from antrea_tpu.agent.apiserver import AgentApiServer as JApi
from antrea_tpu.agent.fqdn import FqdnController as JFqdn
from antrea_tpu.agent.noderoute import NodeRouteController as JNodeRoute
from antrea_tpu.agent.packetcapture import (CaptureSpec as JCaptureSpec,
                                            PacketCaptureController as JPcap)
from antrea_tpu.apis import crd as jcrd
from antrea_tpu.apis.controlplane import Direction, RuleAction
from antrea_tpu.apis.service import Endpoint as JEndpoint
from antrea_tpu.apis.service import ServiceEntry as JServiceEntry
from antrea_tpu.compiler.topology import TrafficControlRule as JTcRule
from antrea_tpu.controller import NetworkPolicyController as JController
from antrea_tpu.controller.traceflow import TraceflowController as JTfc
from antrea_tpu.controller.traceflow import TraceflowSpec as JSpec
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.features import FeatureGates as JGates
from antrea_tpu.packet import PacketBatch as JBatch
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import antctl as tantctl
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.agent.apiserver import AgentApiServer as TApi
from antrea_tpu_torch.agent.fqdn import FqdnController as TFqdn
from antrea_tpu_torch.agent.noderoute import NodeRouteController as TNodeRoute
from antrea_tpu_torch.agent.packetcapture import (
    CaptureSpec as TCaptureSpec, PacketCaptureController as TPcap)
from antrea_tpu_torch.compiler.topology import TrafficControlRule as TTcRule
from antrea_tpu_torch.controller.endpoint_querier import scan_policies
from antrea_tpu_torch.controller.traceflow import TraceflowController as TTfc
from antrea_tpu_torch.controller.traceflow import TraceflowSpec as TSpec
from antrea_tpu_torch.dissemination import serde as tserde
from antrea_tpu_torch.features import FeatureGates as TGates
from antrea_tpu_torch.observability.agentinfo import collect_agent_info
from antrea_tpu_torch.observability.supportbundle import collect_bundle

from test_torch_engine import diff, port_ps, port_svcs, tb
import torch_cpu  # noqa: F401  (one torch thread a worker)

NODE = "n0"
KW = dict(flow_slots=1 << 10, aff_slots=1 << 8, miss_chunk=16,
          canary_probes=0)
WEB, CLI, ISO, BLOCKED = "10.0.0.10", "10.0.0.5", "10.0.0.30", "10.0.0.6"
OPEN = "10.0.1.99"  # a remote node's pod: unregulated
BAD = "203.0.113.7"  # what *.bad.example resolves to
VIP = "10.96.0.1"
_SPORT = itertools.count(42000)
_NOW = itertools.count(100)


def _world():
    ctl = JController()
    ctl.upsert_namespace(jcrd.Namespace("default", {}))
    for name, ip, node, app in (("web", WEB, NODE, "web"),
                                ("cli", CLI, NODE, "cli"),
                                ("iso", ISO, NODE, "iso"),
                                ("blk", BLOCKED, NODE, "blocked"),
                                ("far", OPEN, "n1", "far")):
        ctl.upsert_pod(jcrd.Pod(namespace="default", name=name, ip=ip,
                                node=node, labels={"app": app}))
    sel = jcrd.LabelSelector.make
    ctl.upsert_antrea_policy(jcrd.AntreaNetworkPolicy(
        uid="drop-in", name="drop-in", tier_priority=250, priority=1.0,
        applied_to=[jcrd.AntreaAppliedTo(pod_selector=sel({"app": "web"}))],
        rules=[jcrd.AntreaNPRule(
            direction=Direction.IN, action=RuleAction.DROP,
            peers=[jcrd.AntreaPeer(pod_selector=sel({"app": "blocked"}))])]))
    ctl.upsert_antrea_policy(jcrd.AntreaNetworkPolicy(
        uid="block-bad", name="block-bad", tier_priority=250, priority=2.0,
        applied_to=[jcrd.AntreaAppliedTo(pod_selector=sel({"app": "cli"}))],
        rules=[jcrd.AntreaNPRule(
            direction=Direction.OUT, action=RuleAction.DROP,
            peers=[jcrd.AntreaPeer(fqdn="*.bad.example")])]))
    ctl.upsert_k8s_policy(jcrd.K8sNetworkPolicy(
        uid="isolate", name="isolate", namespace="default",
        pod_selector=sel({"app": "iso"}), policy_types=[Direction.IN],
        ingress=[]))
    svcs = [JServiceEntry(cluster_ip=VIP, port=80, protocol=6,
                          endpoints=[JEndpoint(WEB, 8080, NODE)],
                          name="web", namespace="default")]
    return ctl.policy_set(), svcs


def _batch(rows, in_port=None):
    """rows: (src, dst, dport); each at a fresh source port."""
    kw = {}
    if in_port is not None:
        kw["in_port"] = np.asarray(in_port, np.int32)
    return JBatch(
        src_ip=np.array([iputil.ip_to_u32(s) for s, _, _ in rows], np.uint32),
        dst_ip=np.array([iputil.ip_to_u32(d) for _, d, _ in rows], np.uint32),
        proto=np.full(len(rows), 6, np.int32),
        src_port=np.array([next(_SPORT) for _ in rows], np.int32),
        dst_port=np.array([p for _, _, p in rows], np.int32), **kw)


def _all_rows():
    ips = [WEB, CLI, ISO, BLOCKED, OPEN, BAD, VIP]
    return [(s, d, p) for s in ips for d in ips if s != d for p in (80, 8080)]


class Members:
    """The memberlist surface the server reads (`alive`)."""

    alive = ("n0", "n1")


class Agent:
    """What the server reads of an agent: its PolicySet."""

    def __init__(self, ps):
        self.policy_set = ps


class Side:
    def __init__(self, ps, svcs, engine, tfc, nrc, fqdn, pcap, api, gates,
                 tc_rule, wrap):
        self.wrap = wrap
        self.ps = ps
        self.tfc = tfc()
        self.raw = engine(ps, svcs)
        self.dp = self.tfc.tap(NODE, self.raw)
        self.nrc = nrc(self.raw, NODE, pod_cidr="10.0.0.0/24",
                       gateway_ip="10.0.0.1")
        self.nrc.upsert_node("n1", "192.168.0.2", "10.0.1.0/24")
        for i, ip in enumerate((WEB, CLI, ISO, BLOCKED)):
            self.nrc.pod_added(ip, 3 + i)
        self.nrc.upsert_tc_rule(tc_rule(name="mirror-web", pod_ips=(WEB,),
                                        action=1, target_port=9))
        self.fq = fqdn(self.raw)
        self.fq.configure(ps)
        self.fq.register_maintenance(self.raw.maintenance)
        self.pcap = pcap()
        self.api = api(self.dp, node=NODE, agent=Agent(ps),
                       memberlist=Members(), gates=gates(),
                       tf_controller=self.tfc).start()

    def step(self, b, now):
        r = self.dp.step(self.wrap(b), now)
        self.pcap.observe(self.wrap(b), r, now)
        return r

    def get(self, path):
        with urlopen(self.api.address + path, timeout=10) as r:
            return r.read().decode()


@pytest.fixture(scope="module")
def pair():
    ps, svcs = _world()
    j = Side(copy.deepcopy(ps), svcs,
             lambda p, s: JEngine(p, copy.deepcopy(s), **KW), JTfc,
             JNodeRoute, JFqdn, JPcap, JApi, JGates, JTcRule, lambda b: b)
    t = Side(port_ps(ps), svcs,
             lambda p, s: td.TpuflowDatapath(p, port_svcs(s), device="cpu",
                                             **KW),
             TTfc, TNodeRoute, TFqdn, TPcap, TApi, TGates, TTcRule, tb)
    b = _batch(_all_rows())
    now = next(_NOW)
    diff(j.step(b, now), t.step(b, now), "warm-up")
    yield j, t, ps, svcs
    j.api.close()
    t.api.close()


ROUTES = ["/cache", "/ovsflows?now=105", "/featuregates", "/memberlist",
          "/networkpolicies", "/addressgroups", "/appliedtogroups",
          f"/traceflow?src={CLI}&dst={VIP}&dport=80",
          f"/traceflow?src={BLOCKED}&dst={WEB}&dport=80&in_port=6",
          "/agentinfo?now=7"]


@pytest.mark.parametrize("route", ROUTES)
def test_route_equals_reference(pair, route):
    j, t, _, _ = pair
    assert json.loads(t.get(route)) == json.loads(j.get(route))


@pytest.mark.parametrize("route", ["/commitplane", "/audit", "/maintenance"])
def test_plane_route_has_the_references_keys(pair, route):
    """The commit, audit and maintenance planes' bodies carry ages and
    clocks of their own process: the same keys, and the same generation."""
    j, t, _, _ = pair
    jb, tb_ = json.loads(j.get(route)), json.loads(t.get(route))
    assert set(tb_) == set(jb)
    for k in ("generation", "degraded", "lkg_generation"):
        if k in jb:
            assert tb_[k] == jb[k], k


def test_metrics_and_unknown_route(pair):
    j, t, _, _ = pair
    fam = [{ln.split()[2] for ln in side.get("/metrics").splitlines()
            if ln.startswith("# TYPE")} for side in (j, t)]
    assert fam[1] == fam[0] and "antrea_tpu_flow_cache_entries" in fam[1]
    with pytest.raises(HTTPError) as e:
        t.get("/nope")
    assert e.value.code == 404


def test_agentinfo_of_the_live_engine(pair):
    _, t, ps, _ = pair
    info = collect_agent_info(t.raw, NODE, agent=Agent(t.ps), now=3)
    assert info["datapath"]["type"] == "tpuflow"
    assert info["datapath"]["generation"] == t.raw.generation
    assert info["networkPolicies"] == len(ps.policies) == 3
    assert info["version"] == tantctl.VERSION == jantctl.VERSION


def test_noderoute_topology_forwards_alike(pair):
    """The controller installed node n1's route, n0's pods and a
    TrafficControl rule: equal topologies, equal forwarding verdicts on
    pod, remote, spoofed and mirrored lanes."""
    j, t, _, _ = pair
    assert (tserde.encode_topology(t.nrc.topology)
            == jserde.encode_topology(j.nrc.topology))
    rows = [(WEB, OPEN, 80), (CLI, WEB, 80), (BLOCKED, WEB, 80),
            (WEB, CLI, 8080), (OPEN, WEB, 80)]
    b = _batch(rows, in_port=[3, 4, 4, 3, 1])
    now = next(_NOW)
    rj, rt = j.step(b, now), t.step(b, now)
    diff(rj, rt, "topology")
    assert rt.spoofed.any() and (rt.tc_act != 0).any()


def test_fqdn_learns_through_deltas_and_expires(pair):
    j, t, _, _ = pair
    gen = [s.raw.generation for s in (j, t)]
    assert "fqdn-ttl" in t.raw.maintenance.task_names
    now = next(_NOW)
    for s in (j, t):
        assert s.fq.observe_dns("evil.bad.example", [BAD], ttl_s=30,
                                now=now) == 1
        assert s.fq.observe_dns("good.example", ["198.51.100.9"], 30,
                                now=now) == 0
    assert [s.raw.generation for s in (j, t)] == [g + 1 for g in gen]
    probe = _batch([(CLI, BAD, 80)])
    now = next(_NOW)
    rj, rt = j.step(probe, now), t.step(probe, now)
    diff(rj, rt, "fqdn learned")
    assert int(rt.code[0]) == 1 and rt.egress_rule[0] == "block-bad/Out/0"
    for s in (j, t):
        assert s.fq.tick(now=now + 100) == 1
    probe = _batch([(CLI, BAD, 80)])
    now = next(_NOW)
    rj, rt = j.step(probe, now), t.step(probe, now)
    diff(rj, rt, "fqdn expired")
    assert int(rt.code[0]) == 0


def test_packet_capture_records_alike(pair):
    j, t, _, _ = pair
    now = next(_NOW)
    for s in (j, t):
        spec = (TCaptureSpec if s is t else JCaptureSpec)(
            name="cap", dst_cidr="10.0.0.0/24", dst_port=80, first_n=4)
        s.pcap.start(spec, now)
    b = _batch(_all_rows(), in_port=None)
    rj, rt = j.step(b, now), t.step(b, now)
    diff(rj, rt, "capture batch")
    got, want = t.pcap.status("cap"), j.pcap.status("cap")
    assert got == want and got["done"] and got["captured"] == 4
    assert t.pcap.stop("cap") == j.pcap.stop("cap")


def _live(spec_cls, dst, name, **kw):
    return spec_cls(name=name, dst_ip=dst, proto=6, src_port=0, dst_port=80,
                    live_traffic=True, **kw)


def test_live_traceflow_equals_reference(pair):
    """Allowed, dropped-by-rule and isolated live traces sampled from one
    batch, on both engines and on the port's scalar twin: the same phase,
    verdict and per-stage observations."""
    j, t, _, svcs = pair
    twin_tfc = TTfc()
    twin = twin_tfc.tap(NODE, td.OracleDatapath(
        port_ps(_world()[0]), port_svcs(svcs), flow_slots=1 << 10,
        aff_slots=1 << 8))
    rows = [(CLI, OPEN, 80), (BLOCKED, WEB, 80), (CLI, ISO, 80)]
    b = _batch(rows)
    now = next(_NOW)
    out = []
    for tfc, spec, step in ((j.tfc, JSpec, lambda: j.step(b, now)),
                            (t.tfc, TSpec, lambda: t.step(b, now)),
                            (twin_tfc, TSpec, lambda: twin.step(tb(b), now))):
        for name, dst in (("t-open", OPEN), ("t-drop", WEB),
                          ("t-iso", ISO)):
            tfc.start_live(_live(spec, dst, name), NODE)
        step()
        out.append({n: tfc.results[n] for n in ("t-open", "t-drop",
                                                "t-iso")})
    for name in ("t-open", "t-drop", "t-iso"):
        js, ts, ws = (o[name] for o in out)
        assert ts.phase == js.phase == "Succeeded", name
        assert ts.verdict == js.verdict == ws.verdict, name
        assert ts.observations == js.observations == ws.observations, name
    assert [out[1][n].verdict for n in ("t-open", "t-drop", "t-iso")] == [
        "Allow", "Drop", "Drop"]
    ing = {s["component"]: s for s in out[1]["t-drop"].observations}
    assert ing["IngressSecurity"]["networkPolicyRule"] == "drop-in/In/0"


@pytest.mark.parametrize("knob", [{"dropped_only": True}, {"sampling": 2}])
def test_live_traceflow_filters_equal_reference(pair, knob):
    """droppedOnly skips an allowed match; sampling=2 thins out the first
    match: the same packet completes the trace on both engines."""
    j, t, _, _ = pair
    first = (CLI, WEB, 80) if knob.get("dropped_only") else (BLOCKED, WEB, 80)
    batches = [_batch([first]), _batch([(BLOCKED, WEB, 80)])]
    nows = [next(_NOW), next(_NOW)]
    name = "t-" + "-".join(knob)
    states = []
    for s, spec in ((j, JSpec), (t, TSpec)):
        s.tfc.start_live(_live(spec, WEB, name, **knob), NODE)
        s.step(batches[0], nows[0])
        assert s.tfc.results[name].phase == "Running"
        s.step(batches[1], nows[1])
        states.append(s.tfc.results[name])
    js, ts = states
    assert ts.phase == js.phase == "Succeeded"
    assert ts.observations == js.observations
    cap = ts.observations[0]["capturedPacket"]
    assert cap["srcPort"] == int(batches[1].src_port[0])


def test_live_traceflow_times_out():
    clock = [0.0]
    tfc = TTfc(clock=lambda: clock[0])
    ps, svcs = _world()
    dp = tfc.tap(NODE, td.OracleDatapath(port_ps(ps), port_svcs(svcs),
                                         flow_slots=1 << 10,
                                         aff_slots=1 << 8))
    tfc.start_live(_live(TSpec, WEB, "t-to", src_ip="10.9.9.9"), NODE)
    dp.step(tb(_batch([(CLI, OPEN, 80)])), now=next(_NOW))
    assert tfc.results["t-to"].phase == "Running"
    clock[0] = 1000.0
    tfc.gc()
    st = tfc.results["t-to"]
    assert st.phase == "Failed" and "timeout" in st.observations[0]["action"]
    from antrea_tpu_torch.controller.traceflow import _MAX_TAG

    assert len(tfc._free) == _MAX_TAG


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_antctl_live_mode_equals_reference(pair, capsys):
    j, t, _, _ = pair
    for argv in (["get", "memberlist"], ["get", "featuregates"],
                 ["get", "cache"], ["get", "networkpolicies"],
                 ["traceflow", "--src", BLOCKED, "--dst", WEB]):
        rj, oj = _cli(jantctl.main, argv + ["--server", j.api.address],
                      capsys)
        rt, ot = _cli(tantctl.main, argv + ["--server", t.api.address],
                      capsys)
        assert rt == rj == 0 and ot == oj, argv
    rc, out = _cli(tantctl.main, ["metrics", "--server", t.api.address],
                   capsys)
    assert rc == 0 and "antrea_tpu_flow_cache_entries" in out


def test_antctl_live_traceflow_on_the_ports_engine(pair, capsys):
    """antctl traceflow --live against the port's API server while a thread
    steps the port's engine: the sampled trace of a dropped packet."""
    _, t, _, _ = pair
    stop = threading.Event()
    lock = threading.Lock()

    def pump():
        while not stop.is_set():
            with lock:
                t.dp.step(tb(_batch([(BLOCKED, WEB, 80)])), now=next(_NOW))
            time.sleep(0.02)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        rc, out = _cli(tantctl.main, [
            "traceflow", "--live", "--server", t.api.address, "--dst", WEB,
            "--dport", "80", "--dropped-only", "--wait", "10"], capsys)
    finally:
        stop.set()
        th.join(timeout=5)
    body = json.loads(out)
    assert rc == 0, body
    assert body["phase"] == "Succeeded" and body["verdict"] == "Drop"
    comps = [o["component"] for o in body["observations"]]
    assert comps[0] == "Classification" and comps[-1] == "Output"


def test_antctl_on_a_persist_dir_equals_reference(pair, tmp_path, capsys):
    """The port's engine with a persist dir: both packages' antctl read it
    (get, query endpoint through the endpoint querier, traceflow on the
    scalar twin, supportbundle) and print the same."""
    _, _, ps, svcs = pair
    state = str(tmp_path / "state")
    dp = td.TpuflowDatapath(device="cpu", persist_dir=state, **KW)
    assert dp.install_bundle(ps=port_ps(ps), services=port_svcs(svcs)) == 1
    for argv in (["get", "networkpolicies"], ["get", "addressgroups"],
                 ["get", "appliedtogroups"], ["get", "services"],
                 ["query", "endpoint", "--pod", "web", "--ip", WEB],
                 ["query", "endpoint", "--pod", "cli", "--ip", CLI],
                 ["traceflow", "--src", BLOCKED, "--dst", WEB],
                 ["traceflow", "--src", CLI, "--dst", VIP]):
        rj, oj = _cli(jantctl.main, argv + ["--state", state], capsys)
        rt, ot = _cli(tantctl.main, argv + ["--state", state], capsys)
        assert rt == rj == 0 and ot == oj, argv
    members = {}
    for name, main in (("jax", jantctl.main), ("port", tantctl.main)):
        out = str(tmp_path / f"{name}.tar.gz")
        rc, text = _cli(main, ["supportbundle", "--state", state, "--out",
                               out, "--node", NODE], capsys)
        assert rc == 0
        members[name] = json.loads(text)["members"]
    assert members["port"] == members["jax"]
    assert {"meta.json", "metrics.prom", "flows.json",
            "datapath_snapshot.json"} <= set(members["port"])
    # The live engine's bundle, with its persist dir.
    got = collect_bundle(dp, str(tmp_path / "live.tar.gz"), node=NODE,
                         now=1, persist_dir=state)
    assert set(members["port"]) <= set(got)


def test_endpoint_querier_scan_equals_reference(pair):
    from antrea_tpu.controller.endpoint_querier import (
        scan_policies as jscan)

    _, t, ps, _ = pair
    for ip in (WEB, CLI, ISO, BLOCKED, OPEN):
        for port_side, src in ((True, t.ps), (False, ps)):
            groups = ({k for k, g in src.applied_to_groups.items()
                       if any(m.ip == ip for m in g.members)},
                      {k for k, g in src.address_groups.items()
                       if any(m.ip == ip for m in g.members)})
            res = (scan_policies if port_side else jscan)(src.policies,
                                                          *groups)
            if port_side:
                got = res
            else:
                assert got == res, ip


def test_antctl_check_runs_on_the_cpu(capsys):
    rc, out = _cli(tantctl.main, ["check", "--device", "cpu"], capsys)
    assert rc == 0, out
    assert out.splitlines() == ["native-store: ok", "datapath-parity: ok",
                                "persistence-roundtrip: ok"]
