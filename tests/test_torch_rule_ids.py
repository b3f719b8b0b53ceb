"""The engine's rule attribution resolved on read, on the CPU: a step sets
its StepResult's rule-id fields to RuleIdViews (its own index column and
the id table of its own rule list), and the fields read as the lists the
engine used to build every step (their formula is kept here as the
oracle).  A view keeps its step's ids through a bundle and a tenant swap;
every engine path, the serving batcher, the agent's wire and the
benchmark's check read the same values."""

import dataclasses
import io
import json
import sys
import types

import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one torch thread a worker)
from antrea_tpu_torch.agent import AgentPolicyController
from antrea_tpu_torch.apis import crd
from antrea_tpu_torch.controller import NetworkPolicyController
from antrea_tpu_torch.datapath import OracleDatapath, TpuflowDatapath
from antrea_tpu_torch.datapath.interface import RuleIdView, StepResult
from antrea_tpu_torch.datapath.tpuflow import _RuleIds, _rid
from antrea_tpu_torch.dissemination import RamStore, agent_proc, serde
from antrea_tpu_torch.packet import Packet, PacketBatch
from antrea_tpu_torch.parallel import MeshDatapath
from antrea_tpu_torch.simulator import gen_cluster, gen_traffic
from antrea_tpu_torch.utils import ip as iputil

ENGINE_KW = dict(device="cpu", flow_slots=1 << 10, aff_slots=1 << 8,
                 miss_chunk=64, canary_probes=0)
RULE_FIELDS = ("ingress_rule", "egress_rule")


def old_list(ids: list, idx: np.ndarray) -> list:
    """The per-step list the engine built before the view."""
    arr = np.array([x if x else None for x in ids] + [None], dtype=object)
    n = len(ids)
    return arr[np.where((idx >= 0) & (idx < n), idx, n)].tolist()


IDS = ["p/In/0", "", "p/In/2", "q/In/0", "q/In/1"]
CASES = {
    "in_range": (IDS, [0, 2, 3, 4, 0, 3]),
    "default": (IDS, [-1, -1, 0, -1]),
    "out_of_range": (IDS, [5, 6, 1 << 20, -2, -(1 << 20), 4]),
    "empty_id": (IDS, [1, 1, 0, 1]),
    "mixed": (IDS, [3, -1, 1, 9, 0, 2, -7, 4, 1]),
    "zero_length": (IDS, []),
    "no_rules": ([], [0, -1, 3]),
}


def _result(ingress, egress) -> StepResult:
    z = np.zeros(0, np.int32)
    return StepResult(code=z, est=z, svc_idx=z, dnat_ip=z, dnat_port=z,
                      ingress_rule=ingress, egress_rule=egress,
                      committed=z, n_miss=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_view_reads_what_the_old_list_held(case):
    """A view, and a StepResult field set to it, read the old list: a
    real list, resolved once and then kept in the view's place."""
    ids, col = CASES[case]
    idx = np.asarray(col, np.int32)
    want = old_list(ids, idx)
    assert want == [_rid(ids, int(i)) for i in idx]
    v = _RuleIds()(ids, idx)
    assert isinstance(v, RuleIdView) and v.tolist() == want
    r = _result(v, _RuleIds()(ids, idx[::-1]))
    assert r.__dict__["ingress_rule"] is v
    got = r.ingress_rule
    assert type(got) is list and got == want
    assert r.__dict__["ingress_rule"] is got and r.ingress_rule is got
    assert r.egress_rule == want[::-1]
    assert _result(want, want).ingress_rule is want


def test_rule_id_fields_stay_required_list_fields():
    """The fields keep their place, name and want of a default; replace(),
    repr() and a copy read them as lists."""
    names = [f.name for f in dataclasses.fields(StepResult)]
    assert names[5:8] == ["ingress_rule", "egress_rule", "committed"]
    with pytest.raises(TypeError):
        StepResult(code=None, est=None, svc_idx=None, dnat_ip=None,
                   dnat_port=None, egress_rule=[], committed=None, n_miss=0)
    v = _RuleIds()(IDS, np.array([0, 1, -1, 2], np.int32))
    r = _result(v, [None] * 4)
    want = ["p/In/0", None, None, "p/In/2"]
    r2 = dataclasses.replace(r, n_miss=3)
    assert r2.__dict__["ingress_rule"] == want and r2.ingress_rule == want
    assert "ingress_rule=['p/In/0', None, None, 'p/In/2']" in repr(r)
    # replace() shares the resolved list, as it shares any list.
    assert r2.ingress_rule is r.ingress_rule


def test_view_creation_reads_nothing():
    """A view holds the column it is given and copies nothing when it is
    made; the id table is built once per rule list."""
    r = _RuleIds()
    idx = np.array([0, 1, -1], np.int32)
    v = r(IDS, idx)
    assert v.idx is idx
    assert r(IDS, idx[::-1]).table is v.table
    assert r(list(IDS), idx).table is not v.table


@pytest.fixture(scope="module")
def cluster():
    return gen_cluster(40, n_nodes=2, pods_per_node=8, seed=3)


def _batch(cluster, seed, n=128):
    tr = gen_traffic(cluster.pod_ips, n, n_flows=96, seed=seed)
    return PacketBatch(src_ip=tr.src_ip, dst_ip=tr.dst_ip, proto=tr.proto,
                       src_port=tr.src_port, dst_port=tr.dst_port)


def _attributed(r) -> int:
    return sum(x is not None for x in [*r.ingress_rule, *r.egress_rule])


def test_every_engine_path_returns_views_equal_to_the_oracle(cluster):
    """TpuflowDatapath, the mesh engine and a tenant world all set views;
    the fields read as lists equal to the scalar twin's."""
    b = _batch(cluster, 10)
    oracle = OracleDatapath(cluster.ps, flow_slots=1 << 10)
    eng = TpuflowDatapath(cluster.ps, **ENGINE_KW)
    mesh = MeshDatapath(cluster.ps, None, n_data=2, n_rule=1, **ENGINE_KW)
    tenanted = TpuflowDatapath(gen_cluster(12, seed=8).ps, **ENGINE_KW)
    tid = tenanted.tenant_create("t", cluster.ps, quota=1 << 8)
    for now in (100, 101):
        want = oracle.step(b, now)
        assert isinstance(want.ingress_rule, list)
        for got in (eng.step(b, now), mesh.step(b, now),
                    tenanted.tenant_step(tid, b, now)):
            for f in RULE_FIELDS:
                assert isinstance(got.__dict__[f], RuleIdView), f
                assert type(getattr(got, f)) is list, f
                assert getattr(got, f) == getattr(want, f), f
    assert _attributed(want) > 0


def test_view_keeps_its_steps_ids_through_a_bundle(cluster):
    """A view taken before install_bundle reads the ids of the rule list
    its step ran under, not the new one."""
    b = _batch(cluster, 11)
    eng = TpuflowDatapath(cluster.ps, **ENGINE_KW)
    old_ids = (eng._cps.ingress.rule_ids, eng._cps.egress.rule_ids)
    r = eng.step(b, 100)
    views = (r.__dict__["ingress_rule"], r.__dict__["egress_rule"])
    want = (views[0].tolist(), views[1].tolist())
    assert _attributed(r) > 0
    other = gen_cluster(40, n_nodes=2, pods_per_node=8, seed=4)
    eng.install_bundle(other.ps)
    assert (eng._cps.ingress.rule_ids, eng._cps.egress.rule_ids) != old_ids
    r2 = eng.step(b, 101)
    assert (r2.ingress_rule, r2.egress_rule) != want
    assert (views[0].tolist(), views[1].tolist()) == want
    assert old_list(old_ids[0], views[0].idx) == want[0]


def test_view_keeps_its_steps_ids_through_a_tenant_swap(cluster):
    """A default-world view read after a tenant world stepped, and a
    tenant view read back on the default world, each give their own
    world's ids."""
    b = _batch(cluster, 12)
    eng = TpuflowDatapath(cluster.ps, **ENGINE_KW)
    other = gen_cluster(40, n_nodes=2, pods_per_node=8, seed=5)
    tid = eng.tenant_create("t", other.ps, quota=1 << 8)
    r = eng.step(b, 100)
    want = [*r.__dict__["ingress_rule"].tolist(),
            *r.__dict__["egress_rule"].tolist()]
    rt = eng.tenant_step(tid, b, 101)
    want_t = [*rt.__dict__["ingress_rule"].tolist(),
              *rt.__dict__["egress_rule"].tolist()]
    assert want != want_t
    eng.step(b, 102)
    assert r.ingress_rule + r.egress_rule == want
    assert rt.ingress_rule + rt.egress_rule == want_t
    twin = TpuflowDatapath(other.ps, **ENGINE_KW)
    rw = twin.step(b, 101)
    assert (rt.ingress_rule, rt.egress_rule) == (rw.ingress_rule,
                                                 rw.egress_rule)


def test_serving_batcher_moves_views_lane_by_lane(cluster):
    """step_tenants de-interleaves the dispatches' results into one whose
    ids equal the unbatched steps'; a polled lane reads its id."""
    b = _batch(cluster, 14, n=64)
    eng = TpuflowDatapath(cluster.ps, **ENGINE_KW)
    twin = TpuflowDatapath(cluster.ps, **ENGINE_KW)
    tid = eng.tenant_create("t", cluster.ps, quota=1 << 8)
    tids = np.zeros(b.size, np.int64)
    tids[1::2] = tid
    got = eng.step_tenants(tids, b, 100)
    want = twin.step(b, 100)
    assert got.ingress_rule == want.ingress_rule
    assert got.egress_rule == want.egress_rule
    assert _attributed(want) > 0
    sb = eng.serving_batcher()
    tk = sb.submit(b, 101, tenant=0, shed=False)
    sb.flush_all(101)
    lane = sb.poll(int(np.asarray(tk).ravel()[0]))
    assert lane["ingress_rule"] is None or isinstance(lane["ingress_rule"],
                                                      str)


def _k8s_world():
    ctl = NetworkPolicyController()
    store = RamStore()
    ctl.subscribe(store.apply)
    return ctl, store


def _populate(ctl):
    ctl.upsert_namespace(crd.Namespace(name="default", labels={}))
    ctl.upsert_pod(crd.Pod(namespace="default", name="web", ip="10.0.1.1",
                           node="n1", labels={"app": "web"}))
    ctl.upsert_pod(crd.Pod(namespace="default", name="cli", ip="10.0.2.9",
                           node="n2", labels={"app": "client"}))
    ctl.upsert_k8s_policy(crd.K8sNetworkPolicy(
        uid="np-web", name="np-web", namespace="default",
        pod_selector=crd.LabelSelector.make({"app": "web"}),
        ingress=[crd.K8sNPRule(
            peers=[crd.K8sPeer(pod_selector=crd.LabelSelector.make(
                {"app": "client"}))],
            ports=[crd.PortSpec(protocol=6, port=80)])]))


def test_agent_wire_step_reply_is_json_of_the_old_lists(monkeypatch):
    """agent_proc's step reply, run in this process on the CPU: one line of
    valid JSON whose rule ids equal an in-process engine's lists."""
    ctl, store = _k8s_world()
    watcher = store.watch_queue("n1")
    dp = TpuflowDatapath(device="cpu", miss_chunk=32, flow_slots=1 << 10,
                         aff_slots=1 << 8)
    local = AgentPolicyController("n1", dp, store)
    _populate(ctl)
    ips = ["10.0.1.1", "10.0.2.9", "10.0.7.7"]
    pkts = [Packet(src_ip=iputil.ip_to_u32(s), dst_ip=iputil.ip_to_u32(d),
                   proto=6, src_port=30000 + i, dst_port=80)
            for i, (s, d) in enumerate((s, d) for s in ips for d in ips
                                       if s != d)]
    batch = PacketBatch.from_packets(pkts)
    frames = [{"ev": serde.encode_event(ev)} for ev in watcher.drain()]
    frames += [{"cmd": "sync"},
               {"cmd": "step", "now": 10, "packets": {
                   k: [int(x) for x in getattr(batch, k)]
                   for k in ("src_ip", "dst_ip", "proto", "src_port",
                             "dst_port")}},
               {"cmd": "exit"}]
    stdin = "".join(json.dumps(f) + "\n" for f in frames).encode()
    out = io.BytesIO()
    monkeypatch.setattr(sys, "argv", [
        "agent_proc", "--node", "n1", "--datapath", "tpuflow", "--device",
        "cpu", "--flow-slots", str(1 << 10), "--aff-slots", str(1 << 8)])
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
        buffer=io.BytesIO(stdin)))
    monkeypatch.setattr(sys, "stdout", types.SimpleNamespace(buffer=out))
    assert agent_proc.main() == 0
    lines = out.getvalue().decode().splitlines()
    assert len(lines) == 3
    replies = [json.loads(x) for x in lines]
    assert replies[0]["ok"] and replies[2] == {"ok": True}
    step = replies[1]
    local.sync()
    want = dp.step(batch, 10)
    in_ids, out_ids = dp._cps.ingress.rule_ids, dp._cps.egress.rule_ids
    views = (want.__dict__["ingress_rule"], want.__dict__["egress_rule"])
    assert step["ingress_rule"] == old_list(in_ids, views[0].idx)
    assert step["egress_rule"] == old_list(out_ids, views[1].idx)
    assert step["ingress_rule"] == want.ingress_rule
    assert "np-web" in {x.split("/", 1)[0] for x in step["ingress_rule"]
                        if x is not None}
    assert step["code"] == [int(x) for x in want.code]


def test_benchmark_check_reads_the_view(cluster):
    """flowbench's check (_program_columns) over a real engine step whose
    fields hold views gives the columns of the same step's lists."""
    from flowbench.harness import _program_columns
    from flowbench.reference.datapath import FIELDS

    eng = TpuflowDatapath(cluster.ps, **ENGINE_KW)
    r = eng.step(_batch(cluster, 15), 100)
    lists = {f: r.__dict__[f].tolist() for f in RULE_FIELDS}
    ids = sorted({x for f in RULE_FIELDS for x in lists[f] if x is not None})
    assert len(ids) > 1
    # One id the reference would not know reads -2.
    index = {x: k for k, x in enumerate(ids[1:])}
    assert all(isinstance(r.__dict__[f], RuleIdView) for f in RULE_FIELDS)
    got = _program_columns(r, index)
    for f in FIELDS:
        v = getattr(r, f)
        if f.endswith("_rule"):
            want = np.array([-1 if x is None else index.get(x, -2)
                             for x in lists[f]], np.int64)
        else:
            want = np.asarray(v).astype(np.int64)
        assert got[f].dtype == np.int64
        np.testing.assert_array_equal(got[f], want, err_msg=f)
    assert (got["ingress_rule"] == -2).any() or (got["egress_rule"]
                                                 == -2).any()
