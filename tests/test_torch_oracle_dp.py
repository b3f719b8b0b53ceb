"""The PyTorch port's scalar twin engine (datapath/oracle_dp.OracleDatapath
over oracle/pipeline.PipelineOracle, host-only numpy), held to the JAX
package's on the CPU, and the port's engine held to its twin.

- The port's twin against the JAX package's twin on the same calls (steps
  cold and warm, a bundle, a membership delta, a topology, the async slow
  path's drains): every StepResult field, dump_flows(), stats(),
  cache_stats() and trace() are equal.
- The numpy flow hashes the twin uses equal the JAX package's and the
  port's torch hashes; the pipeline constants the twin imports from the
  port's models/pipeline equal the JAX package's.
- The differential pair: the port's engine on the CPU against the port's
  twin on a small world with node-0's topology, staged unfused, staged
  fused and one-pass, as the JAX package diffs its engine against its twin
  (tests/test_datapath.py).

Batches stay at 96 lanes: the twin walks each packet in Python."""

import dataclasses

import numpy as np
import pytest
import torch

from antrea_tpu.compiler import topology as jtopo
from antrea_tpu.datapath import OracleDatapath as JOracle
from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.ops import hashing as jhash
from antrea_tpu.oracle import pipeline as jop
from antrea_tpu.simulator import gen_cluster, gen_traffic
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.ops import hashing as thash
from antrea_tpu_torch.oracle import hashing as nhash
from antrea_tpu_torch.oracle import pipeline as top

from test_torch_engine import node0, port_ps, port_svcs, tb
from test_torch_tenancy import same_result
import torch_cpu  # noqa: F401  (one torch thread a worker)

KW = dict(flow_slots=1 << 12, aff_slots=1 << 10, canary_probes=8)
MODES = {"staged": {}, "fused": {"fused": True},
         "onepass": {"fused": True, "prune_budget": 2}}


def jps(ps):
    """The JAX package's PolicySet through its wire format, as the port's
    is through its own (test_torch_engine.port_ps).  The generator shares
    GroupMember objects across groups and a deep copy keeps that sharing,
    which the wire format does not; the twin edits member lists in place on
    a delta, so both twins get the wire-decoded set."""
    return jserde.decode_policy_set(jserde.encode_policy_set(ps))


def world():
    cluster = gen_cluster(120, n_nodes=4, pods_per_node=8, seed=3)
    services = gen_services(12, cluster.pod_ips, seed=4)
    return cluster, services


def batch(cluster, services, n, seed):
    return gen_traffic(cluster.pod_ips, n, n_flows=max(8, n // 3), seed=seed,
                       services=services, svc_fraction=0.3)


def test_numpy_hashes_equal_reference():
    """The twin's numpy hashes are the JAX package's bits, and the engine's
    torch hashes (ops/hashing.py) give the same u32 values."""
    rng = np.random.default_rng(1)
    n = 4096
    cols = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(8)]
    proto = rng.choice([1, 6, 17], n).astype(np.int32)
    sport = rng.integers(0, 65536, n).astype(np.int32)
    dport = rng.integers(0, 65536, n).astype(np.int32)
    got = nhash.flow_hash(cols[0], cols[1], proto, sport, dport)
    np.testing.assert_array_equal(
        got, jhash.flow_hash(cols[0], cols[1], proto, sport, dport))
    assert got.dtype == np.uint32
    t = thash.flow_hash(*(torch.from_numpy(c.view(np.int32))
                          for c in cols[:2]),
                        torch.from_numpy(proto), torch.from_numpy(sport),
                        torch.from_numpy(dport))
    np.testing.assert_array_equal(t.numpy(), got.astype(np.int64))
    wide = nhash.flow_hash_wide(cols, proto, sport, dport)
    np.testing.assert_array_equal(
        wide, jhash.flow_hash_wide(cols, proto, sport, dport))
    tw = thash.flow_hash_wide([torch.from_numpy(c.view(np.int32))
                               for c in cols], torch.from_numpy(proto),
                              torch.from_numpy(sport),
                              torch.from_numpy(dport))
    np.testing.assert_array_equal(tw.numpy(), wide.astype(np.int64))
    np.testing.assert_array_equal(nhash.fnv_mix(cols[2:5]),
                                  jhash.fnv_mix(cols[2:5]))
    assert (int(nhash.flow_hash(1, 2, 6, 3, 4))
            == int(jhash.flow_hash(1, 2, 6, 3, 4)))


def test_twin_constants_equal_reference():
    """The constants oracle/pipeline.py takes from the port's
    models/pipeline are the JAX package's."""
    for name in ("CHANCE_MAX", "GEN_ETERNAL", "REJECT_ICMP_UNREACH",
                 "REJECT_NONE", "REJECT_TCP_RST", "_TEARDOWN_FLAGS"):
        assert getattr(top, name) == getattr(jpl, name) == getattr(jop, name)
    for code in range(3):
        for proto in (1, 6, 17):
            assert top._reject_kind(code, proto) == jop._reject_kind(
                code, proto)


@pytest.mark.parametrize("async_slowpath", [False, True],
                         ids=["sync", "async"])
def test_twin_equals_jax_twin(async_slowpath):
    """The same calls on both packages' twins: cold and warm steps with
    node-0's topology, a renumbering bundle, a membership delta, (async)
    drains; every StepResult field, dump_flows(), stats(), cache_stats()
    and trace() equal."""
    cluster, services = world()
    kw = dict(KW, async_slowpath=async_slowpath, drain_batch=64)
    topo = node0(ttopo, cluster)
    j = JOracle(jps(cluster.ps), services,
                topology=node0(jtopo, cluster), **kw)
    t = td.OracleDatapath(port_ps(cluster.ps), port_svcs(services),
                          topology=topo, **kw)
    assert t.datapath_type == td.DatapathType.ORACLE
    b = batch(cluster, services, 96, 10)

    def step(now, bb=b):
        same_result(j.step(bb, now), t.step(tb(bb), now), f"@{now}")
        if async_slowpath:
            assert j.drain_slowpath(now) == t.drain_slowpath(now)

    for now in (100, 101):
        step(now)
    other = gen_cluster(80, n_nodes=4, pods_per_node=8, seed=99)
    assert (j.install_bundle(ps=jps(other.ps))
            == t.install_bundle(ps=port_ps(other.ps)))
    step(102)
    ag = sorted(other.ps.address_groups)[0]
    victim = other.ps.address_groups[ag].members[0].ip
    assert (j.apply_group_delta(ag, ["10.9.9.9"], [victim])
            == t.apply_group_delta(ag, ["10.9.9.9"], [victim]))
    b2 = batch(cluster, services, 96, 11)
    b2.src_ip[:16] = iputil.ip_to_u32("10.9.9.9")
    step(103, b2)
    assert j.dump_flows(104) == t.dump_flows(104)
    assert dataclasses.asdict(j.stats()) == dataclasses.asdict(t.stats())
    assert j.cache_stats() == t.cache_stats()
    assert j.trace(b2, 105) == t.trace(tb(b2), 105)
    assert j.generation == t.generation


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_against_its_twin(mode):
    """The differential pair on the port: the engine on the CPU and the
    twin, node-0's topology, cold, warm, a bundle and a delta; every
    verdict and forwarding field equal, rule ids on freshly classified
    lanes, the per-rule stats, and a cold trace."""
    cluster, services = world()
    topo = node0(ttopo, cluster)
    eng = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                             topology=topo, device="cpu", miss_chunk=64,
                             **KW, **MODES[mode])
    twin = td.OracleDatapath(port_ps(cluster.ps), port_svcs(services),
                             topology=topo, **KW)
    fields = ("code", "est", "reply", "reject_kind", "snat", "svc_idx",
              "dnat_ip", "dnat_port", "committed", "spoofed", "fwd_kind",
              "out_port", "peer_ip", "dec_ttl")
    b = tb(batch(cluster, services, 96, 20))
    ta, to = eng.trace(b, 10), twin.trace(b, 10)
    for i in range(b.size):
        for k in ("code", "svc_idx", "dnat_ip", "dnat_port", "ingress_rule",
                  "egress_rule", "fwd_kind", "out_port"):
            assert ta[i][k] == to[i][k], (i, k)

    def diff(a, o, rules=True):
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(o, f),
                                          err_msg=f)
        assert a.n_miss == o.n_miss
        if rules:
            fresh = (a.est == 0) & (a.committed == 0) & (a.code != 0)
            for i in np.nonzero(fresh)[0]:
                assert a.ingress_rule[i] == o.ingress_rule[i], i
                assert a.egress_rule[i] == o.egress_rule[i], i

    for now in (100, 101):
        diff(eng.step(b, now), twin.step(b, now))
    assert (dataclasses.asdict(eng.stats())
            == dataclasses.asdict(twin.stats()))
    ag = sorted(cluster.ps.address_groups)[0]
    victim = cluster.ps.address_groups[ag].members[0].ip
    assert (eng.apply_group_delta(ag, ["10.9.9.9"], [victim])
            == twin.apply_group_delta(ag, ["10.9.9.9"], [victim]))
    b2 = tb(batch(cluster, services, 96, 21))
    b2.src_ip[:16] = iputil.ip_to_u32("10.9.9.9")
    diff(eng.step(b2, 102), twin.step(b2, 102))
    other = gen_cluster(80, n_nodes=4, pods_per_node=8, seed=99)
    assert (eng.install_bundle(ps=port_ps(other.ps))
            == twin.install_bundle(ps=port_ps(other.ps)))
    r = eng.step(b, 103)
    diff(r, twin.step(b, 103), rules=False)
    assert int(r.est.sum()) > 0
