"""The PyTorch port's forwarding walk (antrea_tpu_torch/models/forwarding.py)
against the JAX package's, on the CPU.  Every value is an int32 word: the
tolerance is exact equality.  The lookups run on seeded lanes over
tests/test_forwarding.py's three-node topology with TrafficControl rules;
the full walk, staged and one-pass, on a 300-rule world seen from node-0,
over two steps, with spoofed, ARP, IGMP, multicast and FIN/RST lanes and
external valid / no_commit masks; after each step every output key and
every flow-cache and affinity column must be equal (dump row excluded).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antrea_tpu.compiler import topology as jtopo
from antrea_tpu.compiler.compile import compile_policy_set
from antrea_tpu.compiler.services import compile_services
from antrea_tpu.compiler.topology import (TC_MIRROR, TC_REDIRECT, NodeRoute,
                                          Topology, TrafficControlRule,
                                          compile_topology)
from antrea_tpu.models import forwarding as jfw
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.simulator import gen_cluster, gen_services, gen_traffic
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.compiler.compile import compile_policy_set as t_compile
from antrea_tpu_torch.compiler.services import \
    compile_services as t_compile_services
from antrea_tpu_torch.models import forwarding as tfw
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.simulator import gen_cluster as t_gen_cluster
from antrea_tpu_torch.simulator import gen_services as t_gen_services
import torch_cpu  # noqa: F401  (one torch thread a worker)

B = 128
KW = dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a),
                                                 dtype=np.int32))


def _topo(tc_rules=()):
    """tests/test_forwarding.py's world as seen from node-a: pods
    10.10.0.0/24 local (ofports 3/4/5), nodes b/c remote."""
    return Topology(
        node_name="node-a",
        gateway_ip="10.10.0.1",
        pod_cidr="10.10.0.0/24",
        local_pods=[("10.10.0.5", 3), ("10.10.0.6", 4), ("10.10.0.7", 5)],
        remote_nodes=[
            NodeRoute(name="node-b", node_ip="192.168.1.2",
                      pod_cidr="10.10.1.0/24"),
            NodeRoute(name="node-c", node_ip="192.168.1.3",
                      pod_cidr="10.10.2.0/24"),
        ],
        tc_rules=list(tc_rules),
    )


_TC = [
    TrafficControlRule(name="mirror-7", pod_ips=("10.10.0.7",),
                       action=TC_MIRROR, target_port=99, direction="ingress"),
    TrafficControlRule(name="redirect-5", pod_ips=("10.10.0.5",),
                       action=TC_REDIRECT, target_port=88, direction="egress"),
]


def test_topology_copy_compiles_the_same_tables():
    """compiler/topology.py is a copy: the same topology compiles to the
    same tables, and fwd_to_device carries them table for table."""
    ft = compile_topology(_topo(_TC))
    tft = ttopo.compile_topology(_topo(_TC))
    assert ttopo.ForwardingTables._fields == type(ft)._fields
    dft = tfw.fwd_to_device(tft, "cpu")
    jdft = jax.device_get(jfw.fwd_to_device(ft))
    for f in type(ft)._fields:
        np.testing.assert_array_equal(getattr(tft, f), getattr(ft, f),
                                      err_msg=f)
        got = getattr(dft, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jdft,
                                                                      f)),
                                      err_msg=f)


def test_lookups_equal_reference():
    """spoof_lookup, forwarding_lookup and tc_lookup on seeded lanes: IPs
    drawn around the local pods, the podCIDRs, the gateway and outside,
    and in_port over the tunnel, gateway, pod and unset ports."""
    ft = compile_topology(_topo(_TC))
    dft = tfw.fwd_to_device(ttopo.compile_topology(_topo(_TC)), "cpu")
    jdft = jfw.fwd_to_device(ft)
    rng = np.random.default_rng(3)
    n = 512
    pool = [iputil.ip_to_u32(a) for a in (
        "10.10.0.5", "10.10.0.6", "10.10.0.7", "10.10.0.9", "10.10.0.1",
        "10.10.1.4", "10.10.2.200", "10.10.3.1", "8.8.8.8", "192.168.1.2",
        "224.0.0.1", "239.1.2.3")]
    src = iputil.flip_u32(rng.choice(np.array(pool, np.uint32), n))
    dst = iputil.flip_u32(rng.choice(np.array(pool, np.uint32), n))
    in_port = rng.choice(np.array([-1, 1, 2, 3, 4, 5, 6], np.int32), n)
    src_t, dst_t, port_t = _t(src), _t(dst), _t(in_port)

    want = np.asarray(jfw.spoof_lookup(jdft, jnp.asarray(src),
                                       jnp.asarray(in_port)))
    got = tfw.spoof_lookup(dft, src_t, port_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()

    jf = jax.device_get(jfw.forwarding_lookup(jdft, jnp.asarray(dst),
                                              jnp.asarray(in_port)))
    tf = tfw.forwarding_lookup(dft, dst_t, port_t)
    assert set(tf) == set(jf)
    for k, v in jf.items():
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert len(np.unique(np.asarray(jf["kind"]))) >= 4

    want = np.asarray(jfw.tc_lookup(jdft, jnp.asarray(src), jf["lp_row"],
                                    jf["is_local"]))
    got = tfw.tc_lookup(dft, src_t, tf["lp_row"], tf["is_local"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want & 3)) >= {TC_MIRROR, TC_REDIRECT}


def test_wide_helpers_equal_reference():
    """_lex_le, _row_eq_wide and spoof_lookup's wide (v6) leg on seeded
    4-word rows: words from a small range, so rows share prefixes and tie;
    half the probes are table rows, some of them past the row count."""
    rng = np.random.default_rng(8)
    a = rng.integers(-2, 3, (256, 4)).astype(np.int32)
    b = rng.integers(-2, 3, (256, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tfw._lex_le(_t(a), _t(b)).numpy(),
        np.asarray(jfw._lex_le(jnp.asarray(a), jnp.asarray(b))))
    table = rng.integers(-3, 3, (8, 4)).astype(np.int32)
    n = np.array([5], np.int32)
    xw = np.where(rng.random((64, 1)) < 0.5, table[rng.integers(0, 8, 64)],
                  rng.integers(-3, 3, (64, 4))).astype(np.int32)
    got = tfw._row_eq_wide(_t(table), _t(n), _t(xw))
    want = jfw._row_eq_wide(jnp.asarray(table), jnp.asarray(n),
                            jnp.asarray(xw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[1]).any() and not np.asarray(want[1]).all()
    ports = rng.integers(3, 7, 8).astype(np.int32)
    ft = compile_topology(_topo())
    dft = tfw.fwd_to_device(ttopo.compile_topology(_topo()), "cpu")._replace(
        lp6_ipw=_t(table), lp6_port=_t(ports), n_lp6=_t(n))
    jdft = jfw.fwd_to_device(ft)._replace(
        lp6_ipw=jnp.asarray(table), lp6_port=jnp.asarray(ports),
        n_lp6=jnp.asarray(n))
    src = iputil.flip_u32(rng.integers(0, 2**32, 64, dtype=np.uint64)
                          .astype(np.uint32))
    in_port = rng.integers(1, 7, 64).astype(np.int32)
    is6 = rng.integers(0, 2, 64).astype(np.int32)
    got = tfw.spoof_lookup(dft, _t(src), _t(in_port), src_w=_t(xw),
                           is6=_t(is6))
    want = jfw.spoof_lookup(jdft, jnp.asarray(src), jnp.asarray(in_port),
                            src_w=jnp.asarray(xw), is6=jnp.asarray(is6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the full walk ---------------------------------------------------------


def _node0(pod_ips, n_nodes, pods_per_node, tc=(), mcast=()):
    """Node-0's topology in a gen_cluster world (pods at 10.0.<node>.x):
    its pods at ofports from 3, the other nodes remote at their pod
    CIDRs."""
    return dict(
        node_name="node-0",
        gateway_ip="10.0.0.1",
        pod_cidr="10.0.0.0/24",
        local_pods=[(iputil.u32_to_ip(int(u)), 3 + i)
                    for i, u in enumerate(pod_ips[:pods_per_node])],
        remote_nodes=[dict(name=f"node-{k}", node_ip=f"192.168.0.{k + 1}",
                           pod_cidr=f"10.0.{k}.0/24")
                      for k in range(1, n_nodes)],
        tc_rules=list(tc), mcast_groups=list(mcast))


def _topology(mod, spec):
    return mod.Topology(**dict(
        spec, remote_nodes=[mod.NodeRoute(**r) for r in spec["remote_nodes"]],
        mcast_groups=[mod.McastGroup(**g) for g in spec["mcast_groups"]]))


@pytest.fixture(scope="module")
def walk_world():
    kw = dict(n_nodes=4, pods_per_node=16, seed=7)
    cluster = gen_cluster(300, **kw)
    services = gen_services(16, cluster.pod_ips, affinity_fraction=0.3,
                            no_ep_fraction=0.1, seed=9)
    tcl = t_gen_cluster(300, **kw)
    tsvcs = t_gen_services(16, tcl.pod_ips, affinity_fraction=0.3,
                           no_ep_fraction=0.1, seed=9)
    pods = cluster.pod_ips
    tc = [dict(name="mirror", pod_ips=(iputil.u32_to_ip(int(pods[2])),),
               action=TC_MIRROR, target_port=99, direction="ingress"),
          dict(name="redirect", pod_ips=(iputil.u32_to_ip(int(pods[3])),),
               action=TC_REDIRECT, target_port=88, direction="egress")]
    mc = [dict(group_ip="239.1.1.1", local_ports=(3, 4))]
    spec = _node0(pods, 4, 16, mcast=mc)
    spec["tc_rules"] = [TrafficControlRule(**r) for r in tc]
    ft = compile_topology(_topology(jtopo, spec))
    spec["tc_rules"] = [ttopo.TrafficControlRule(**r) for r in tc]
    tft = ttopo.compile_topology(_topology(ttopo, spec))
    return dict(cluster=cluster, services=services,
                cps=compile_policy_set(cluster.ps),
                svc=compile_services(services), ft=ft,
                tcps=t_compile(tcl.ps), tsvc=t_compile_services(tsvcs),
                tft=tft)


def walk_lanes(pod_ips, services, seed, b=B, local=16):
    """A seeded batch over a node-0 world (see _node0), in numpy: the five
    tuple columns, in_port (each local source's own port, else the tunnel
    or the gateway; a tenth of the lanes spoofed with another pod's port),
    flags (FIN or RST on a fifth of the lanes), arp_op (requests for a
    local pod, the gateway and an unknown address, and replies), an IGMP
    lane and multicast destinations (a joined group and one without
    receivers).  -> dict of int32 arrays."""
    tr = gen_traffic(pod_ips, b, n_flows=b // 2, seed=seed,
                     services=services, svc_fraction=0.3)
    rng = np.random.default_rng(seed)
    src = tr.src_ip.astype(np.uint32).copy()
    dst = tr.dst_ip.astype(np.uint32).copy()
    proto = tr.proto.astype(np.int32).copy()
    port_of = {int(u): 3 + i for i, u in enumerate(pod_ips[:local])}
    in_port = np.array([port_of.get(int(s), int(rng.choice([1, 2])))
                        for s in src], np.int32)
    spoof = rng.random(b) < 0.1
    in_port[spoof] = 3 + (in_port[spoof] + 1) % local
    flags = np.where(rng.random(b) < 0.2,
                     rng.choice([tpl.TCP_FIN, tpl.TCP_RST], b), 0
                     ).astype(np.int32)
    arp_op = np.zeros(b, np.int32)
    gw = iputil.ip_to_u32("10.0.0.1")
    for i, (op, target) in enumerate([(1, int(pod_ips[1])), (1, gw),
                                      (1, iputil.ip_to_u32("10.0.0.250")),
                                      (2, int(pod_ips[1]))]):
        arp_op[b - 1 - i] = op
        dst[b - 1 - i] = target
    proto[b - 5] = 2  # IGMP
    dst[b - 6] = iputil.ip_to_u32("239.1.1.1")
    dst[b - 7] = iputil.ip_to_u32("239.9.9.9")
    return dict(src=iputil.flip_u32(src), dst=iputil.flip_u32(dst),
                proto=proto, sport=tr.src_port.astype(np.int32),
                dport=tr.dst_port.astype(np.int32), in_port=in_port,
                flags=flags, arp_op=arp_op)


_COLS = ("src", "dst", "proto", "sport", "dport", "in_port")


def _compare(jstate, jout, tstate, tout, what):
    jout = jax.device_get(jout)
    assert set(tout) == set(jout), what
    for k, v in jout.items():
        got = tout[k].numpy()
        assert got.dtype == np.int32, (what, k)
        np.testing.assert_array_equal(got, np.asarray(v),
                                      err_msg=f"{what}: out[{k}]")
    jstate = jax.device_get(jstate)
    for part in ("flow", "aff"):
        jt, tt = getattr(jstate, part), getattr(tstate, part)
        for f in jt._fields:
            np.testing.assert_array_equal(
                getattr(tt, f).numpy()[:-1], np.asarray(getattr(jt, f))[:-1],
                err_msg=f"{what}: {part}.{f}")


@pytest.mark.parametrize("knobs", [
    dict(fused=True),
    dict(fused=True, prune_budget=2),
], ids=["staged", "onepass"])
def test_pipeline_step_full_equals_reference(walk_world, knobs):
    w = walk_world
    jstep, jstate, (jdrs, jdsvc) = jpl.make_pipeline(w["cps"], w["svc"],
                                                     **KW, **knobs)
    jdft = jfw.fwd_to_device(w["ft"])
    tstep, tstate, (tdrs, tdsvc) = tpl.make_pipeline(
        w["tcps"], w["tsvc"], device="cpu", **KW, **knobs)
    assert tstep.meta.onepass == jstep.meta.onepass == (
        "prune_budget" in knobs)
    tdft = tfw.fwd_to_device(w["tft"], "cpu")
    lanes = walk_lanes(w["cluster"].pod_ips, w["services"], seed=11)
    rng = np.random.default_rng(5)
    valid = rng.random(B) < 0.9
    no_commit = rng.random(B) < 0.1
    zero = np.zeros(B, np.int32)
    for t, flags in enumerate((zero, lanes["flags"])):
        now = 1000 + t
        jstate, jout = jfw.pipeline_step_full(
            jstate, jdrs, jdsvc, jdft, *(jnp.asarray(lanes[c])
                                         for c in _COLS),
            now, 0, jnp.asarray(flags), jnp.asarray(lanes["arp_op"]),
            meta=jstep.meta, valid=jnp.asarray(valid),
            no_commit=jnp.asarray(no_commit))
        tstate, tout = tfw.pipeline_step_full(
            tstate, tdrs, tdsvc, tdft, *(_t(lanes[c]) for c in _COLS),
            now, 0, _t(flags), _t(lanes["arp_op"]), meta=tstep.meta,
            valid=torch.from_numpy(valid),
            no_commit=torch.from_numpy(no_commit))
        _compare(jstate, jout, tstate, tout, f"step {t}")
        o = {k: v.numpy() for k, v in tout.items()}
        if t == 0:
            cold = o
    # The interesting branches fired.
    kinds = set(np.unique(cold["fwd_kind"]))
    assert {ttopo.FWD_DROP_SPOOF, ttopo.FWD_PUNT, ttopo.FWD_ARP_REPLY,
            ttopo.FWD_ARP_FLOOD, ttopo.FWD_LOCAL, ttopo.FWD_TUNNEL,
            ttopo.FWD_MCAST, ttopo.FWD_DROP_MCAST} <= kinds, kinds
    assert cold["spoofed"].any() and cold["committed"].any()
    assert (cold["committed"][no_commit] == 0).all()
    assert (cold["miss"][~valid] == 0).all()
    assert o["est"].any()
    assert int(o["n_miss"]) < int(cold["n_miss"])
    if "prune_budget" in knobs:
        assert int(cold["n_prune_fb"]) + int(cold["n_prune_skips"]) > 0


@pytest.mark.parametrize("knobs", [
    dict(fused=True, prune_budget=2, onepass=False),
    dict(fused=True, prune_budget=2),
], ids=["staged_pruned", "onepass"])
def test_pipeline_step_full_prune_exclude_equals_reference(walk_world, knobs):
    """prune_exclude (the mesh engine's spill mask) through the full walk,
    staged pruned and one-pass, with telemetry on: every output and the
    tables bitwise equal to the JAX walk, and the excluded lanes carry no
    prune evidence and no probe counters."""
    w = walk_world
    kw = dict(KW, telemetry=True, **knobs)
    jstep, jstate, (jdrs, jdsvc) = jpl.make_pipeline(w["cps"], w["svc"],
                                                     **kw)
    jdft = jfw.fwd_to_device(w["ft"])
    tstep, tstate, (tdrs, tdsvc) = tpl.make_pipeline(
        w["tcps"], w["tsvc"], device="cpu", **kw)
    assert tstep.meta.onepass == jstep.meta.onepass == (
        knobs.get("onepass", True))
    tdft = tfw.fwd_to_device(w["tft"], "cpu")
    lanes = walk_lanes(w["cluster"].pod_ips, w["services"], seed=13)
    rng = np.random.default_rng(8)
    valid = rng.random(B) < 0.9
    excl = rng.random(B) < 0.3
    for t in range(2):
        now = 1000 + t
        jstate, jout = jfw.pipeline_step_full(
            jstate, jdrs, jdsvc, jdft, *(jnp.asarray(lanes[c])
                                         for c in _COLS),
            now, 0, jnp.asarray(lanes["flags"]),
            jnp.asarray(lanes["arp_op"]), meta=jstep.meta,
            valid=jnp.asarray(valid), prune_exclude=jnp.asarray(excl))
        tstate, tout = tfw.pipeline_step_full(
            tstate, tdrs, tdsvc, tdft, *(_t(lanes[c]) for c in _COLS),
            now, 0, _t(lanes["flags"]), _t(lanes["arp_op"]),
            meta=tstep.meta, valid=torch.from_numpy(valid),
            prune_exclude=torch.from_numpy(excl))
        _compare(jstate, jout, tstate, tout, f"step {t}")
        o = {k: v.numpy() for k, v in tout.items()}
        # Every valid lane the walk keeps (no spoof, ARP or IGMP) is probed
        # once; the excluded ones are counted in no probe counter, and
        # their misses in no candidate histogram bucket.
        probed = int(o["tel_probe_hit"] + o["tel_probe_stale"]
                     + o["tel_probe_miss"])
        kept = (valid & (o["spoofed"] == 0) & (o["punt"] == 0)
                & (lanes["arp_op"] == 0))
        assert probed == int((kept & ~excl).sum()), t
        miss = o["miss"] != 0
        assert int(o["prune_cand_hist"][:-1].sum()) == int(
            (miss & ~excl).sum()), t
        if t == 0:
            assert (miss & excl).any() and (miss & ~excl).any()
