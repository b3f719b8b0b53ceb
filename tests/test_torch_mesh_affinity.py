"""Session affinity on the mesh engine, on the CPU: each data replica keeps
its own affinity table, so a (2, 1) engine may send a sticky client's
fresh flow to another endpoint than a (1, 1) engine does.

The world is the one of tests/test_torch_reshard.py with one service of
four endpoints and ClientIP affinity.  One client opens a flow to it; in
the next step it opens 64 more, half homed on each replica
(shard_of_tuples), none spilled.  A (1, 1) engine sends all 64 to the
first flow's endpoint; a (2, 1) engine does so only on the first flow's
replica, and picks anew (the flow hash) on the other.  The JAX package's
MeshDatapath does exactly that, and the port's equals it at each shape on
every StepResult field (int32 words: exact equality).

chip_smoke.py phase 18 holds its (2, 1) and (4, 1) engines to a (1, 1)
reference and, on such lanes, to its StickyWitness: the endpoint one of
the service's, code and rule ids the scalar Oracle's at that endpoint, at
most a capped number of lanes.  The last test runs that witness on these
engines and on copies of their results with one word changed."""

import dataclasses

import numpy as np
import pytest

import jax

from antrea_tpu.apis.controlplane import PROTO_TCP
from antrea_tpu.apis.service import Endpoint, ServiceEntry
from antrea_tpu.packet import PacketBatch as JBatch
from antrea_tpu.parallel import MeshDatapath as JMesh
from antrea_tpu.parallel import mesh as jpm
from antrea_tpu.simulator.genpolicy import gen_cluster
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.parallel import MeshDatapath as TMesh
from antrea_tpu_torch.parallel import mesh as tpm

import chip_smoke
from test_torch_engine import port_ps, port_svcs, tb
from test_torch_meshpath import FIELDS, jps
import torch_cpu  # noqa: F401  (one torch thread a worker)

KW = dict(flow_slots=1 << 8, aff_slots=1 << 6, canary_probes=8)
LANES = 64
VIP = "10.96.0.200"
SHAPES = ((2, 1), (1, 1))


def _homes(src, dst, sport, dport):
    n = len(src)
    return tpm.shard_of_tuples(
        np.asarray(src, np.uint32), np.asarray(dst, np.uint32),
        np.full(n, 6, np.int32), np.asarray(sport, np.int32),
        np.asarray(dport, np.int32), 2)


def _batch(src, dst, sport, dport):
    return JBatch(src_ip=np.asarray(src, np.uint32),
                  dst_ip=np.asarray(dst, np.uint32),
                  proto=np.full(LANES, 6, np.int32),
                  src_port=np.asarray(sport, np.int32),
                  dst_port=np.asarray(dport, np.int32))


@pytest.fixture(scope="module")
def world():
    """(cluster, [the sticky service], first, second, home of the first
    flow, homes of the second batch's lanes)."""
    cluster = gen_cluster(40, n_nodes=4, pods_per_node=6, seed=7)
    pods = [int(x) for x in cluster.pod_ips]
    svc = ServiceEntry(
        cluster_ip=VIP, port=80, protocol=PROTO_TCP,
        endpoints=[Endpoint(ip=iputil.u32_to_ip(pods[i]), port=8080)
                   for i in (3, 9, 15, 21)],
        affinity_timeout_s=300, name="sticky", namespace="ns-0")
    vip, client = iputil.ip_to_key(VIP), pods[0]
    # The second batch: 64 flows of the client to the VIP, 32 homed on
    # each replica (so none spills to a foreign replica).
    cand = 20000 + np.arange(4 * LANES)
    h = _homes([client] * cand.size, [vip] * cand.size, cand,
               [80] * cand.size)
    pick = np.sort(np.concatenate([np.nonzero(h == r)[0][:LANES // 2]
                                   for r in (0, 1)]))
    sports = cand[pick]
    second = _batch([client] * LANES, [vip] * LANES, sports, [80] * LANES)
    home2 = _homes(second.src_ip, second.dst_ip, sports, [80] * LANES)
    # The first batch: the client's first flow (the second batch's lane 0)
    # and 63 pod-to-pod flows of other pods, 32 lanes homed on each
    # replica.
    h0 = int(home2[0])
    n = 4 * LANES
    osrc = [pods[1 + i % 20] for i in range(n)]
    odst = [pods[(5 + 7 * i) % len(pods)] for i in range(n)]
    osp = 30000 + np.arange(n)
    ho = _homes(osrc, odst, osp, [80] * n)
    other = np.concatenate([np.nonzero(ho == h0)[0][:LANES // 2 - 1],
                            np.nonzero(ho != h0)[0][:LANES // 2]])
    first = _batch([client] + [osrc[i] for i in other],
                   [vip] + [odst[i] for i in other],
                   [sports[0]] + [int(osp[i]) for i in other],
                   [80] * LANES)
    return cluster, [svc], first, second, h0, home2


def _walk(dp, cv, first, second):
    dp.step(cv(first), 100)
    return dp.step(cv(second), 101)


def _port_engine(world, shape):
    cluster, svcs = world[:2]
    return TMesh(port_ps(cluster.ps), port_svcs(svcs), n_data=shape[0],
                 n_rule=shape[1], device="cpu", **KW)


@pytest.fixture(scope="module")
def jax_results(world):
    """The JAX MeshDatapath's second step at each shape."""
    cluster, svcs, first, second = world[:4]
    out = {}
    for shape in SHAPES:
        mesh = jpm.make_mesh(*shape, devices=jax.devices("cpu")[:shape[0]])
        dp = JMesh(jps(cluster.ps), svcs, mesh=mesh, **KW)
        out[shape] = _walk(dp, lambda b: b, first, second)
    return out


def test_mesh_affinity_is_per_replica_as_in_the_jax_engine(world,
                                                           jax_results):
    """The JAX (2, 1) engine sends the sticky client's flows homed on the
    other replica to the flow hash's endpoints, where its (1, 1) engine
    sends every flow to the first flow's endpoint; the port's engines
    equal the JAX engines at each shape, word for word."""
    _, svcs, first, second, h0, home2 = world
    wide, one = jax_results[(2, 1)], jax_results[(1, 1)]
    eps = {(iputil.ip_to_key(e.ip), e.port) for e in svcs[0].endpoints}
    assert (np.asarray(one.svc_idx) == 0).all()
    ep0 = (int(one.dnat_ip[0]), int(one.dnat_port[0]))
    assert ep0 in eps
    assert set(zip(np.asarray(one.dnat_ip).tolist(),
                   np.asarray(one.dnat_port).tolist())) == {ep0}
    moved = ((np.asarray(wide.dnat_ip) != np.asarray(one.dnat_ip))
             | (np.asarray(wide.dnat_port) != np.asarray(one.dnat_port)))
    assert moved.any()
    assert not moved[home2 == h0].any()
    assert set(zip(np.asarray(wide.dnat_ip).tolist(),
                   np.asarray(wide.dnat_port).tolist())) <= eps
    np.testing.assert_array_equal(wide.svc_idx, one.svc_idx)
    for shape in SHAPES:
        got = _walk(_port_engine(world, shape), tb, first, second)
        want = jax_results[shape]
        for f in FIELDS:
            w = getattr(want, f)
            if w is None:
                assert getattr(got, f) is None, (shape, f)
            else:
                np.testing.assert_array_equal(
                    np.asarray(getattr(got, f)), np.asarray(w),
                    err_msg=f"{shape} {f}")
        assert got.ingress_rule == want.ingress_rule, shape
        assert got.egress_rule == want.egress_rule, shape
        assert int(got.n_miss) == int(want.n_miss), shape


def test_phase18_sticky_witness_holds_the_moved_lanes(world):
    """chip_smoke's same_verdicts on the port's (2, 1) engine against its
    (1, 1) engine: the moved lanes pass the StickyWitness and are counted;
    a changed code, rule id or endpoint on a moved lane, a changed code on
    another lane, and more moved lanes than the cap each fail."""
    cluster, svcs, first, second = world[:4]
    res = {s: _walk(_port_engine(world, s), tb, first, second)
           for s in SHAPES}
    a, b = res[(2, 1)], res[(1, 1)]
    moved = np.nonzero(np.asarray(a.dnat_ip) != np.asarray(b.dnat_ip))[0]
    kept = np.nonzero(np.asarray(a.dnat_ip) == np.asarray(b.dnat_ip))[0]
    assert moved.size and kept.size
    ps, psvcs = port_ps(cluster.ps), port_svcs(svcs)
    aff = np.asarray([s.affinity_timeout_s for s in psvcs], np.int32)
    batch = tb(second)

    def check(x, cap=chip_smoke.MAX_STICKY_LANES):
        w = chip_smoke.StickyWitness(ps, psvcs, cap=cap)
        n = chip_smoke.same_verdicts(x, b, "test", batch, w, aff)
        return n, w.lanes

    assert check(a) == (moved.size, moved.size)
    i, j = int(moved[0]), int(kept[0])
    code = np.asarray(a.code).copy()
    code[i] ^= 1
    rule = list(a.ingress_rule)
    rule[i] = "np-0/x/0" if rule[i] is None else None
    port = np.asarray(a.dnat_port).copy()
    port[i] += 1
    kept_code = np.asarray(a.code).copy()
    kept_code[j] ^= 1
    for bad in (dataclasses.replace(a, code=code),
                dataclasses.replace(a, ingress_rule=rule),
                dataclasses.replace(a, dnat_port=port),
                dataclasses.replace(a, code=kept_code)):
        with pytest.raises(SystemExit):
            check(bad)
    with pytest.raises(SystemExit, match="more than"):
        check(a, cap=moved.size - 1)
