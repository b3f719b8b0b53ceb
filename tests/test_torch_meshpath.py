"""The PyTorch port's mesh engine (antrea_tpu_torch/parallel/meshpath.py)
against the JAX package's MeshDatapath, on the CPU: the step, the spill and
its home-routed retry, the verdicts, the full walk and membership deltas.

The JAX engine runs on conftest's virtual CPU devices, one per shard; the
port holds the same (data x rule) mesh in one process (a LocalMesh), its
rule shards in threads that meet at each combine.  Both take the same
numpy-seeded world and batches (tests/test_mesh_datapath.py's tiny world
and knobs).  Every value is an int32 word, so the tolerance is exact
equality: every StepResult field and rule id, each replica's dump_flows()
and tables (dump row excluded; every rule shard's copy of a replica's
state), cache_stats(), mesh_stats(), the scrub digests.
tests/test_torch_meshpath_planes.py holds the slow path, the commit and
audit planes and the surfaces."""

import dataclasses
import inspect
import threading

import numpy as np
import pytest
import torch

import jax

from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.packet import PacketBatch as JBatch
from antrea_tpu.parallel import MeshDatapath as JMesh
from antrea_tpu.parallel import mesh as jpm
from antrea_tpu.parallel import meshpath as jmeshpath
from antrea_tpu.simulator.genpolicy import gen_cluster
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu.simulator.traffic import gen_traffic
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.ops import onepass as top
from antrea_tpu_torch.oracle.interpreter import Oracle as TOracle
from antrea_tpu_torch.parallel import MeshDatapath as TMesh
from antrea_tpu_torch.parallel import mesh as tpm

from test_torch_engine import port_ps, port_svcs, tb
import torch_cpu  # noqa: F401  (one torch thread a worker)

KW = dict(flow_slots=1 << 10, aff_slots=1 << 8, canary_probes=16)
MODES = {"staged": {}, "fused": {"fused": True},
         "onepass": {"fused": True, "prune_budget": 2}}
FIELDS = ("code", "est", "reply", "reject_kind", "snat", "dsr", "svc_idx",
          "dnat_ip", "dnat_port", "committed", "spoofed", "punt",
          "mcast_idx", "l7_redirect", "fwd_kind", "out_port", "peer_ip",
          "dec_ttl", "tc_act", "tc_port", "pending")


@pytest.fixture(scope="module")
def world():
    cluster = gen_cluster(60, n_nodes=4, pods_per_node=8, seed=7)
    services = gen_services(8, cluster.pod_ips, seed=11)
    return cluster, services


@pytest.fixture(scope="module")
def meshes():
    """One JAX mesh per shape for the module, so every engine of a shape
    shares the JAX engine's compiled programs."""
    cpus = jax.devices("cpu")
    return {s: jpm.make_mesh(*s, devices=cpus[:s[0] * s[1]])
            for s in ((2, 2), (1, 1), (1, 2))}


@pytest.fixture(scope="module")
def batch(world):
    cluster, services = world
    return gen_traffic(cluster.pod_ips, 256, n_flows=96, seed=3,
                       services=services, svc_fraction=0.3)


def jps(ps):
    """A JAX engine's own copy of a PolicySet (deltas rewrite members)."""
    return jserde.decode_policy_set(jserde.encode_policy_set(ps))


def engines(world, meshes, shape=(2, 2), services=True, jkw=None, tkw=None,
            **extra):
    """The JAX MeshDatapath and the port's on the same world and knobs
    (jkw / tkw: each package's own objects, e.g. its Topology)."""
    cluster, svcs = world
    svcs = svcs if services else None
    j = JMesh(jps(cluster.ps), svcs, mesh=meshes[shape], **KW, **extra,
              **(jkw or {}))
    t = TMesh(port_ps(cluster.ps), None if svcs is None else port_svcs(svcs),
              n_data=shape[0], n_rule=shape[1], device="cpu", **KW, **extra,
              **(tkw or {}))
    return j, t


def same_result(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, (what, f)
            continue
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=f"{what}: {f}")
    assert a.n_miss == b.n_miss, what
    assert a.ingress_rule == b.ingress_rule, what
    assert a.egress_rule == b.egress_rule, what


def same_state(j, t, what):
    """Every rule shard's copy of every replica's tables equal to the JAX
    engine's replica row (dump row excluded)."""
    js = jax.device_get(j._state)
    assert len(t._state) == js.flow.keys.shape[0], what
    for d, row in enumerate(t._state):
        for r, st in enumerate(row):
            for part in ("flow", "aff"):
                jt, tt = getattr(js, part), getattr(st, part)
                for f in jt._fields:
                    np.testing.assert_array_equal(
                        getattr(tt, f).numpy()[:-1],
                        np.asarray(getattr(jt, f))[d, :-1],
                        err_msg=f"{what}: replica {d} copy {r} {part}.{f}")


def same_surfaces(j, t, now, what):
    """Generation, each replica's dump_flows(), the census, the meters,
    mesh_stats(), the tables and the scrub digests (both engines' dump
    rows zeroed first)."""
    assert j.generation == t.generation, what
    for d in range(len(t._state)):
        local = jax.tree.map(lambda x, d=d: x[d], j._state)
        assert (j._dump_flows_state(local, now)
                == t._dump_flows_state(t._state[d][0], now)), (what, d)
    assert j.dump_flows(now) == t.dump_flows(now), what
    assert j.cache_stats() == t.cache_stats(), what
    assert dataclasses.asdict(j.stats()) == dataclasses.asdict(t.stats()), what
    assert j.mesh_stats() == t.mesh_stats(), what
    jp, tp = j.prune_stats(), t.prune_stats()
    assert (jp is None) == (tp is None), what
    if jp is not None:
        for k in ("budget", "skips_total", "fallbacks_total",
                  "classified_total"):
            assert jp[k] == tp[k], (what, k)
    assert j._audit_rule_digests() == t._audit_rule_digests(), what
    same_state(j, t, what)
    # The dump rows take the masked lanes' scratch writes, whichever wins;
    # zeroed in both engines (no lookup reads them), the state digests
    # must agree.
    j._state = jax.tree.map(lambda x: x.at[:, -1].set(0), j._state)
    for row in t._state:
        for st in row:
            for leaf in (*st.flow, *st.aff):
                leaf[-1] = 0
    assert j._audit_state_digest() == t._audit_state_digest(), what


def same_slowpath_stats(j, t, what):
    """slowpath_stats() equal, its drain histogram by counts."""
    js, ts = j.slowpath_stats(), t.slowpath_stats()
    jh, th = js.pop("drain_hist"), ts.pop("drain_hist")
    assert ts == js, what
    assert (th._counts, th.sum, th.count) == (jh._counts, jh.sum,
                                              jh.count), what


def sub(b, idx):
    return JBatch.from_packets([b.packet(int(i)) for i in idx])


# ---- host routing and the in-process combine --------------------------------


@pytest.mark.parametrize("n_data,skew", [(1, False), (2, False), (2, True),
                                         (3, False), (4, True)])
def test_shard_placement_equals_reference(n_data, skew):
    rng = np.random.default_rng(n_data)
    shard = rng.integers(0, n_data, 96 * n_data).astype(np.int32)
    if skew:
        shard[: shard.size * 3 // 4] = 0
    for g, w in zip(tpm._shard_placement(shard, n_data),
                    jmeshpath._shard_placement(shard, n_data)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_rule_group_combine_is_the_elementwise_minimum():
    """run_rule_group: n shards in n threads, each combine returning the
    elementwise minimum of every shard's tensor (the bits of an all-reduce
    MIN), round after round; the identity on one shard; a failing shard
    raises its own error and stops the others at their next combine."""
    g = torch.Generator().manual_seed(3)
    n, rounds = 3, 4
    hs = torch.randint(-2**31, 2**31 - 1, (rounds, n, 64, 9), generator=g,
                       dtype=torch.int64).to(torch.int32)
    w0s = [(0, 0), (32, 32), (64, 64)]

    def fn(r, comb):
        assert comb.w0 == w0s[r] and comb.r == r
        return [comb(hs[k, r]) for k in range(rounds)]

    got = tpm.run_rule_group(w0s, fn)
    want = hs.amin(dim=1)
    for r in range(n):
        for k in range(rounds):
            assert torch.equal(got[r][k], want[k]), (r, k)
    one = tpm.run_rule_group([(0, 0)], lambda r, comb: comb(hs[0, 0]))
    assert torch.equal(one[0], hs[0, 0])

    def bad(r, comb):
        comb(hs[0, r])
        if r == 1:
            raise KeyError("shard 1")
        return comb(hs[1, r])

    with pytest.raises(KeyError, match="shard 1"):
        tpm.run_rule_group(w0s, bad)


def test_rule_group_combine_under_thread_switching():
    """More rule-shard threads than cores, switching every microsecond,
    many rounds: a slot overwritten before every shard read it would give
    some shard a wrong minimum.  Time-bounded."""
    import sys

    g = torch.Generator().manual_seed(9)
    n, rounds = 16, 40
    hs = torch.randint(-2**31, 2**31 - 1, (rounds, n, 32, 9), generator=g,
                       dtype=torch.int64).to(torch.int32)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: got.append(tpm.run_rule_group(
            [(r, r) for r in range(n)],
            lambda r, comb: [comb(hs[k, r]) for k in range(rounds)])))
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and got
    want = hs.amin(dim=1)
    for r in range(n):
        for k in range(rounds):
            assert torch.equal(got[0][r][k], want[k]), (r, k)


# ---- the step against the JAX mesh engine ------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_step_equals_reference(world, meshes, batch, mode):
    """(2, 2), two steps of the same batch (cold, then cached): every
    result field and the surfaces bitwise equal to the JAX mesh engine,
    the verdicts equal to the port's single-card engine, the replicas'
    private caches adding up to the global census."""
    cluster, services = world
    j, t = engines(world, meshes, **MODES[mode])
    s = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu", **KW, **MODES[mode])
    for k in range(2):
        rj = j.step(batch, 100 + k)
        rt = t.step(tb(batch), 100 + k)
        same_result(rj, rt, f"{mode} step {k}")
        rs = s.step(tb(batch), 100 + k)
        for f in ("code", "svc_idx", "dnat_ip", "dnat_port"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rs, f))
        assert rt.ingress_rule == rs.ingress_rule
        assert rt.egress_rule == rs.egress_rule
    assert int(rt.est.sum()) > 0
    same_surfaces(j, t, 102, mode)
    c = t.cache_stats()
    assert c["slots"] == 2 * KW["flow_slots"] and c["occupied"] > 0


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)], ids=["1x1", "1x2"])
def test_onepass_rule_shards_run_hits_only(world, meshes, batch, monkeypatch,
                                           shape):
    """The one-pass mesh step at one and two rule shards: B3's hits-only
    variant (never the resolve variant: the mesh always passes a combine,
    the identity at one shard), at w0 > 0 on the second shard, bitwise
    equal to the JAX mesh engine."""
    calls = {True: 0, False: 0}
    plain = top.onepass_plain
    sig = inspect.signature(plain)

    def counted(*a, **k):
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        calls[bool(bound.arguments["resolve"])] += 1
        return plain(*a, **k)

    monkeypatch.setattr(top, "onepass_plain", counted)
    j, t = engines(world, meshes, shape, **MODES["onepass"])
    for k in range(2):
        same_result(j.step(batch, 100 + k), t.step(tb(batch), 100 + k),
                    f"{shape} step {k}")
    same_surfaces(j, t, 102, f"{shape}")
    assert calls[True] == 0 and calls[False] >= shape[1]
    assert t._drs.w0[0] == (0, 0)
    if shape[1] == 2:
        assert min(t._drs.w0[1]) > 0, t._drs.w0


def test_mesh_verdicts_equal_the_oracle(world, meshes):
    """Non-service traffic, two steps (the second serves cached verdicts):
    every code equals the port's scalar Oracle."""
    cluster, _ = world
    t = TMesh(port_ps(cluster.ps), None, n_data=2, n_rule=2, device="cpu",
              **KW)
    tr = tb(gen_traffic(cluster.pod_ips, 128, n_flows=64, seed=13))
    oracle = TOracle(port_ps(cluster.ps))
    want = [int(oracle.classify(tr.packet(i)).code) for i in range(tr.size)]
    for k in range(2):
        np.testing.assert_array_equal(t.step(tr, 200 + k).code, want)


# ---- hash skew: spill and the home-routed retry ------------------------------


def _skew(cluster, n=64):
    big = gen_traffic(cluster.pod_ips, 512, n_flows=256, seed=17)
    shard = jpm.shard_of_tuples(big.src_ip, big.dst_ip, big.proto,
                                big.src_port, big.dst_port, 2)
    idx = np.nonzero(shard == 0)[0][:n]
    assert idx.size == n
    return sub(big, idx)


def test_spill_lanes_classify_but_never_cache_foreign(world, meshes):
    """Every lane homes to replica 0: half spill to replica 1, which
    classifies them (no_commit) and caches nothing; the retry re-serves
    them at home.  Bitwise equal to the JAX engine, replica by replica."""
    cluster, _ = world
    j, t = engines(world, meshes)
    skew = _skew(cluster)
    same_result(j.step(skew, 300), t.step(tb(skew), 300), "skew")
    occ = [int((row[0].flow.keys[:-1, -1] != 0).sum()) for row in t._state]
    assert occ[1] == 0 and occ[0] > 0, occ
    ms = t.mesh_stats()
    assert ms["spill_retried_total"] == ms["spill_lanes_total"] == 32
    same_surfaces(j, t, 301, "skew")


def test_spill_hold_admission_serves_cached_verdicts(world, meshes):
    """admission="hold" under skew: after a drain, the spilled established
    flows serve their cached verdicts through the retry, bitwise equal to
    the JAX engine (pending lanes included)."""
    cluster, _ = world
    kw = dict(async_slowpath=True, admission="hold",
              miss_queue_slots=1 << 12, drain_batch=256)
    j, t = engines(world, meshes, services=False, **kw)
    skew = _skew(cluster)
    for dp, b in ((j, skew), (t, tb(skew))):
        dp.step(b, 100)
        dp.drain_slowpath(101)
    rj, rt = j.step(skew, 102), t.step(tb(skew), 102)
    same_result(rj, rt, "hold")
    assert int(rt.pending.sum()) < 8
    same_slowpath_stats(j, t, "hold")
    same_surfaces(j, t, 103, "hold")


# ---- the full walk and membership deltas -------------------------------------


def _fwd_topo(mod, n_pods=3):
    return mod.Topology(
        node_name="node-a", gateway_ip="10.10.0.1",
        pod_cidr="10.10.0.0/24",
        local_pods=[(f"10.10.0.{5 + i}", 3 + i) for i in range(n_pods)],
        remote_nodes=[mod.NodeRoute(name="node-b", node_ip="192.168.1.2",
                                    pod_cidr="10.10.1.0/24")])


def test_mesh_full_walk_and_topology_swap_equal_reference(world, meshes):
    """SpoofGuard -> policy/service -> forward -> Output through the mesh
    step, then install_topology: bitwise equal to the JAX engine."""
    from antrea_tpu.compiler import topology as jtopo

    rows = [("10.10.0.5", "10.10.0.6", 3), ("10.10.0.5", "10.10.1.9", 3),
            ("10.10.0.6", "8.8.8.8", 4), ("10.10.0.5", "10.10.0.99", 3),
            ("10.10.1.9", "10.10.0.5", ttopo.OFPORT_TUNNEL),
            ("10.10.0.9", "10.10.0.6", 3), ("10.10.0.7", "10.10.0.5", 5),
            ("10.10.0.6", "10.10.0.7", 4)]
    b = JBatch(src_ip=np.array([iputil.ip_to_u32(s) for s, _, _ in rows],
                               np.uint32),
               dst_ip=np.array([iputil.ip_to_u32(d) for _, d, _ in rows],
                               np.uint32),
               proto=np.full(8, 6, np.int32),
               src_port=np.full(8, 40000, np.int32),
               dst_port=np.full(8, 80, np.int32),
               in_port=np.array([p for _, _, p in rows], np.int32))
    j, t = engines(world, meshes, jkw=dict(topology=_fwd_topo(jtopo)),
                   tkw=dict(topology=_fwd_topo(ttopo)))
    for k in (100, 101):
        rt = t.step(tb(b), k)
        same_result(j.step(b, k), rt, f"walk {k}")
    assert int(rt.spoofed.sum()) == 1
    j.install_topology(_fwd_topo(jtopo, 2))
    t.install_topology(_fwd_topo(ttopo, 2))
    same_result(j.step(b, 102), t.step(tb(b), 102), "swapped topology")
    same_surfaces(j, t, 103, "walk")


def test_mesh_group_delta_slot_path_equals_reference(world, meshes):
    """A pod joins and leaves an address group on the slot path (no
    recompile): the slot masks split on the word axis over both rule
    shards, each step and surface bitwise equal to the JAX engine."""
    cluster, _ = world
    j, t = engines(world, meshes)
    group = sorted(cluster.ps.address_groups)[0]
    fresh = "172.31.9.9"
    cps0 = t._cps
    assert j.apply_group_delta(group, [fresh], []) == \
        t.apply_group_delta(group, [fresh], []) == 1
    assert t._cps is cps0 and t._n_deltas == j._n_deltas >= 1
    assert t._meta.delta_n == t._n_deltas
    tr = gen_traffic(cluster.pod_ips, 128, n_flows=64, seed=23)
    same_result(j.step(tr, 100), t.step(tb(tr), 100), "after add")
    key = iputil.ip_to_u32(fresh)
    pods = [int(u) for u in sorted(cluster.pod_ips)[:2]]
    db = JBatch(src_ip=np.array([key, pods[0]], np.uint32),
                dst_ip=np.array([pods[1], key], np.uint32),
                proto=np.full(2, 6, np.int32),
                src_port=np.full(2, 40000, np.int32),
                dst_port=np.full(2, 80, np.int32))
    same_result(j.step(db, 101), t.step(tb(db), 101), "delta lanes")
    j.apply_group_delta(group, [], [fresh])
    t.apply_group_delta(group, [], [fresh])
    same_result(j.step(db, 102), t.step(tb(db), 102), "after remove")
    same_surfaces(j, t, 103, "deltas")
    ev = [e for e in t.flightrecorder_events(kind="commit") if e.get("delta")]
    assert ev and ev[-1]["outcome"] == "ok" and ev[-1]["stage"] == "settle"
