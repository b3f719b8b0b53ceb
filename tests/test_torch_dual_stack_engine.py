"""The PyTorch port's dual-stack engine and full walk against the JAX
package's TpuflowDatapath(dual_stack=True), on the CPU.

One dual-stack node (tests/test_ipv6_datapath.py's: v4 and v6 pods, a
remote node's v6 podCIDR over a v4 underlay tunnel, v6 and v4 Services)
built once per mode (staged unfused, staged fused, staged pruned) in both
packages, stepped in lockstep on padded 32-lane batches through the cases
of tests/test_ipv6_datapath.py (the v6 forwarding walk, a v6 ClusterIP
through the walk with its conntrack, Neighbor Discovery, policy on the
walk, a seeded differential) and tests/test_ipv6.py's v6 group deltas.
After every step every StepResult field (dnat_key and peer_key included),
dump_flows(), the flow and affinity tables (the dump row excluded) and
trace() are bitwise equal.  Then the JAX engine's dual-stack refusals
(tests/test_match_fused.py:437 and its neighbours) raised by the port as
ConfigErrors with the same words, and the v4 engine's refusal of a v6
batch."""

import copy
import dataclasses

import numpy as np
import pytest

import jax

from antrea_tpu.apis import controlplane as cp
from antrea_tpu.apis.service import Endpoint, ServiceEntry
from antrea_tpu.compiler import topology as jtopo
from antrea_tpu.compiler.compile import ACT_ALLOW, ACT_DROP
from antrea_tpu.compiler.ir import PolicySet
from antrea_tpu.compiler.topology import (ARP_OP_REQUEST, FWD_ARP_FLOOD,
                                          FWD_ARP_REPLY, FWD_DROP_SPOOF,
                                          FWD_DROP_UNKNOWN, FWD_GATEWAY,
                                          FWD_LOCAL, FWD_TUNNEL)
from antrea_tpu.config import ConfigError as JConfigError
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.ops import match as jm
from antrea_tpu.packet import Packet, PacketBatch
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch import packet as tpk
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.config import ConfigError as TConfigError
from antrea_tpu_torch.dissemination import serde as tserde
from antrea_tpu_torch.ops import match as tm

GW4, GW6 = "10.10.0.1", "fd00:10::1"
POD_A4, POD_A6 = "10.10.0.5", "fd00:10::5"  # a local dual-stack pod, port 3
POD_B6 = "fd00:10::6"  # a local v6 pod, port 4
POD_C6 = "fd00:10::7"  # a local v6 pod, port 5
REMOTE_POD6 = "fd00:10:0:1::9"  # on n1's v6 podCIDR
REMOTE_BAD6 = "fd00:10:0:1::a5"  # in the dropped block
NODE1_V4 = "192.168.1.2"
VIP6, VIP6B, VIP4 = "fd00:96::10", "fd00:96::20", "10.96.0.10"
LANES = 32
KW = dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=16,
          dual_stack=True, canary_probes=0, node_ips=[NODE1_V4, GW6],
          delta_slots=8)
MODES = {"staged": {}, "fused": {"fused": True}, "pruned": {"prune_budget": 2}}
_FIELDS = ("code", "est", "reply", "reject_kind", "snat", "dsr", "svc_idx",
           "dnat_ip", "dnat_port", "committed", "spoofed", "punt",
           "mcast_idx", "l7_redirect", "fwd_kind", "out_port", "peer_ip",
           "dec_ttl", "tc_act", "tc_port")


def _topo(mod):
    return mod.Topology(
        node_name="n0", gateway_ip=GW4, gateway_ip6=GW6,
        pod_cidr="10.10.0.0/24", pod_cidr6="fd00:10:0:0::/64",
        local_pods=[(POD_A4, 3), (POD_A6, 3), (POD_B6, 4), (POD_C6, 5)],
        remote_nodes=[mod.NodeRoute("n1", NODE1_V4, "10.10.1.0/24"),
                      mod.NodeRoute("n1", NODE1_V4, "fd00:10:0:1::/64")])


def _world():
    """tests/test_ipv6_datapath.py:172 and :204's policies on one node: the
    web pods drop the `bad` group and a v4 and a v6 block; v6 and v4
    Services to local and remote pods."""
    ps = PolicySet()
    ps.applied_to_groups["web"] = cp.AppliedToGroup(
        name="web", members=[cp.GroupMember(ip=POD_B6, node="n0"),
                             cp.GroupMember(ip=POD_A4, node="n0")])
    ps.address_groups["bad"] = cp.AddressGroup(
        name="bad", members=[cp.GroupMember(ip=POD_A6, node="n0")])
    ps.policies.append(cp.NetworkPolicy(
        uid="p", name="p", type=cp.NetworkPolicyType.ACNP,
        applied_to_groups=["web"], tier_priority=250, priority=1.0,
        rules=[cp.NetworkPolicyRule(
            direction=cp.Direction.IN,
            from_peer=cp.NetworkPolicyPeer(
                address_groups=["bad"],
                ip_blocks=[cp.IPBlock("fd00:10:0:1::a0/124"),
                           cp.IPBlock("10.10.1.0/24")]),
            action=cp.RuleAction.DROP, priority=0)]))
    svcs = [ServiceEntry(cluster_ip=VIP6, port=80, protocol=6,
                         endpoints=[Endpoint(POD_B6, 8080, node="n0")]),
            ServiceEntry(cluster_ip=VIP6B, port=80, protocol=6,
                         endpoints=[Endpoint(POD_B6, 8080, node="n0"),
                                    Endpoint(REMOTE_POD6, 8080, node="n1")],
                         affinity_timeout_s=60),
            ServiceEntry(cluster_ip=VIP4, port=80, protocol=6,
                         endpoints=[Endpoint(POD_A4, 8080, node="n0")])]
    return ps, svcs


@pytest.fixture(scope="module")
def engines():
    """Per mode, the JAX engine and the port's on the same world."""
    ps, svcs = _world()
    out = {}
    for mode, knobs in MODES.items():
        j = JEngine(copy.deepcopy(ps), svcs, topology=_topo(jtopo), **KW,
                    **knobs)
        t = td.TpuflowDatapath(
            tserde.decode_policy_set(jserde.encode_policy_set(ps)),
            [tserde.decode_service_entry(jserde.encode_service_entry(s))
             for s in svcs], topology=_topo(ttopo), device="cpu", **KW,
            **knobs)
        assert not t._meta.onepass and t._meta.key_words == 10
        out[mode] = (j, t)
    return out


def _pkt(src, dst, dport=80, proto=6, sport=40000):
    return Packet(src_ip=iputil.ip_to_key(src), dst_ip=iputil.ip_to_key(dst),
                  proto=proto, src_port=sport, dst_port=dport)


def _batch(pkts, in_ports=None, arp=None):
    """Padded to LANES with lanes of an unused flow; every batch carries an
    arp_op column, so each engine steps one program."""
    n = len(pkts)
    b = PacketBatch.from_packets(
        list(pkts) + [_pkt("fd00:99::9", "fd00:99::8", 9, sport=9)] *
        (LANES - n))
    b.in_port = np.full(LANES, -1, np.int32)
    if in_ports is not None:
        b.in_port[:n] = in_ports
    b.arp_op = np.zeros(LANES, np.int32)
    if arp is not None:
        b.arp_op[:n] = arp
    return b


def _tb(b):
    return tpk.PacketBatch(**{f.name: getattr(b, f.name)
                              for f in dataclasses.fields(b)})


def _step(pair, b, now):
    """One step of both engines -> the port's StepResult; every field,
    dump_flows() and both tables bitwise equal."""
    j, t = pair
    rj, rt = j.step(b, now), t.step(_tb(b), now)
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rt, f)),
                                      np.asarray(getattr(rj, f)),
                                      err_msg=f"now={now} {f}")
    assert rt.n_miss == rj.n_miss
    assert (rt.ingress_rule, rt.egress_rule) == (rj.ingress_rule,
                                                 rj.egress_rule)
    assert rt.dnat_key == rj.dnat_key and rt.peer_key == rj.peer_key
    assert t.dump_flows(now) == j.dump_flows(now)
    js = jax.device_get(j._state)
    for part in ("flow", "aff"):
        for f, tt in zip(getattr(js, part)._fields, getattr(t._state, part)):
            np.testing.assert_array_equal(
                tt.numpy()[:-1], np.asarray(getattr(getattr(js, part),
                                                    f))[:-1],
                err_msg=f"now={now} {part}.{f}")
    return rt


def _trace(pair, b, now):
    j, t = pair
    assert t.trace(_tb(b), now) == j.trace(b, now)


@pytest.mark.parametrize("mode", list(MODES))
def test_v6_forwarding_walk(engines, mode):
    """tests/test_ipv6_datapath.py:85: local v6 delivery, the v6 tunnel
    over the v4 underlay, the gateway default, the unknown-pod drop in the
    local v6 CIDR, the v6 spoof drop."""
    cases = [(POD_C6, POD_B6, 5, FWD_LOCAL, 4),
             (POD_C6, REMOTE_POD6, 5, FWD_TUNNEL, 1),
             (POD_C6, "fd00:99::1", 5, FWD_GATEWAY, 2),
             (REMOTE_POD6, POD_C6, 1, FWD_LOCAL, 5),
             (POD_C6, "fd00:10::77", 5, FWD_DROP_UNKNOWN, -1),
             ("fd00:bad::1", POD_B6, 3, FWD_DROP_SPOOF, -1)]
    r = _step(engines[mode], _batch(
        [_pkt(s, d, sport=30000 + i) for i, (s, d, *_) in enumerate(cases)],
        in_ports=[c[2] for c in cases]), 1)
    assert list(r.fwd_kind[:6]) == [c[3] for c in cases]
    assert list(r.out_port[:6]) == [c[4] for c in cases]
    assert r.peer_key[1] == iputil.ip_to_key(NODE1_V4)
    assert int(r.dec_ttl[1]) == 1
    assert int(r.spoofed[5]) == 1 and int(r.committed[5]) == 0


@pytest.mark.parametrize("mode", list(MODES))
def test_v6_clusterip_walk_and_conntrack(engines, mode):
    """tests/test_ipv6_datapath.py:112: a v6 ClusterIP through the walk
    (DNAT to a local v6 endpoint, its ofport), the established hit, the
    reply's un-DNAT delivered to the client's port, dump_flows() over
    wide keys, trace()."""
    pair = engines[mode]
    fwd = _batch([_pkt(POD_C6, VIP6, 80, sport=41000)], in_ports=[5])
    r = _step(pair, fwd, 2)
    assert int(r.code[0]) == 0 and r.dnat_key[0] == iputil.ip_to_key(POD_B6)
    assert (int(r.fwd_kind[0]), int(r.out_port[0])) == (FWD_LOCAL, 4)
    r = _step(pair, fwd, 3)
    assert int(r.est[0]) == 1
    rev = _batch([Packet(iputil.ip_to_key(POD_B6), iputil.ip_to_key(POD_C6),
                         6, 8080, 41000)], in_ports=[4])
    r = _step(pair, rev, 4)
    assert int(r.reply[0]) == 1 and r.dnat_key[0] == iputil.ip_to_key(VIP6)
    assert (int(r.fwd_kind[0]), int(r.out_port[0])) == (FWD_LOCAL, 5)
    flows = pair[1].dump_flows(4)
    e = [f for f in flows if f["src"] == POD_C6 and f["sport"] == 41000][0]
    assert e["dst"] == VIP6 and e["dnat_ip"] == POD_B6
    _trace(pair, _batch([_pkt(POD_C6, VIP6, 80, sport=41000),
                         _pkt(POD_C6, VIP6B, 80, sport=41001),
                         _pkt(POD_A4, VIP4, 80, sport=41002)], [5, 5, 3]), 5)


@pytest.mark.parametrize("mode", list(MODES))
def test_v6_nd_responder(engines, mode):
    """tests/test_ipv6_datapath.py:153: Neighbor Discovery lanes answer for
    the v6 gateway and a local v6 pod, and flood otherwise."""
    r = _step(engines[mode], _batch(
        [_pkt(POD_C6, GW6, 0, proto=0), _pkt(POD_C6, POD_B6, 0, proto=0),
         _pkt(POD_C6, "fd00:77::1", 0, proto=0)], [5, 5, 5],
        [ARP_OP_REQUEST] * 3), 6)
    assert list(r.fwd_kind[:3]) == [FWD_ARP_REPLY, FWD_ARP_REPLY,
                                    FWD_ARP_FLOOD]
    assert int(r.out_port[0]) == 5


@pytest.mark.parametrize("mode", list(MODES))
def test_v6_policy_on_walk(engines, mode):
    """tests/test_ipv6_datapath.py:172: a drop on the v6 endpoint fires for
    ClusterIP traffic after DNAT; another client is delivered."""
    r = _step(engines[mode], _batch(
        [_pkt(POD_A6, VIP6, 80, sport=42000),
         _pkt(REMOTE_POD6, VIP6, 80, sport=42001)], [3, 1]), 7)
    assert int(r.code[0]) == ACT_DROP and int(r.out_port[0]) == -1
    assert r.ingress_rule[0] is not None
    assert int(r.code[1]) == ACT_ALLOW
    assert (int(r.fwd_kind[1]), int(r.out_port[1])) == (FWD_LOCAL, 4)


@pytest.mark.parametrize("mode", list(MODES))
def test_v6_randomized_walk(engines, mode):
    """tests/test_ipv6_datapath.py:204: a seeded mix of both families over
    Services, local and remote pods and the dropped blocks, three steps."""
    rng = np.random.default_rng(7)
    srcs = [POD_A6, POD_A4, POD_B6, POD_C6, REMOTE_POD6, REMOTE_BAD6,
            "10.10.1.7", "fd00:99::3"]
    dsts = [VIP6, VIP6B, VIP4, POD_B6, POD_A4, REMOTE_POD6, "fd00:10::77"]
    ports = {POD_A6: 3, POD_A4: 3, POD_B6: 4, POD_C6: 5}
    for now in range(8, 11):
        pkts, inp = [], []
        while len(pkts) < LANES:
            s, d = srcs[rng.integers(len(srcs))], dsts[rng.integers(len(dsts))]
            if iputil.is_v6(s) != iputil.is_v6(d):
                continue
            pkts.append(_pkt(s, d, sport=int(rng.integers(40000, 40500))))
            inp.append(ports.get(s, 1 if s.startswith("fd00:10:0:1") else -1))
        _step(engines[mode], _batch(pkts, inp), now)


@pytest.mark.parametrize("mode", list(MODES))
def test_v6_group_delta_is_incremental(engines, mode):
    """tests/test_ipv6.py:362: a v6 member joining a group takes a delta
    slot (no recompile) on both engines and the classify and the walk see
    it; leaving appends a clear slot.  Runs last: it moves the world."""
    j, t = engines[mode]
    probe = _batch([_pkt(REMOTE_POD6, POD_B6, 80, sport=43000 + i)
                    for i in range(3)], [1, 1, 1])
    want = (ACT_DROP, ACT_ALLOW)
    for k, (added, removed) in enumerate((([REMOTE_POD6], []),
                                          ([], [REMOTE_POD6]))):
        inc0 = t._drs.ingress.at.inc
        assert (j.apply_group_delta("bad", added, removed)
                == t.apply_group_delta("bad", added, removed))
        assert t._n_deltas == j._n_deltas == t._meta.delta_n
        assert t._drs.ingress.at.inc is inc0
        cols = tuple(iputil.flip_u32(c) for c in (probe.src_ip, probe.dst_ip))
        six = tuple(iputil.flip_u32(c) for c in (probe.src_ip6, probe.dst_ip6))
        jc = jm._classify_jit(
            j._drs, *cols, probe.proto.astype(np.int32),
            probe.dst_port.astype(np.int32), meta=j._meta.match,
            v6=six + (probe.is6,))
        tc_ = tm.classify_batch(
            t._drs, *(t._lane(c) for c in cols), t._lane(probe.proto),
            t._lane(probe.dst_port), meta=t._meta.match,
            fused=t._meta.fused, delta_n=t._meta.delta_n,
            v6=tuple(t._lane(c) for c in six + (probe.is6,)))
        for key in ("code", "ingress_rule", "egress_rule"):
            np.testing.assert_array_equal(tc_[key].numpy(),
                                          np.asarray(jc[key]), err_msg=key)
        assert int(tc_["code"][0]) == want[k]
        r = _step((j, t), probe, 20 + k)
        assert int(r.code[0]) == want[k]
        _trace((j, t), probe, 20 + k)


def test_canary_certifies_v6_deltas_through_the_trace_walk():
    """A dual-stack engine's canary walks its probes through the full trace
    (the JAX engine's rule): v6 deltas certify and the engine stays
    healthy; audit_scan re-proves the wide rows."""
    ps, svcs = _world()
    t = td.TpuflowDatapath(
        tserde.decode_policy_set(jserde.encode_policy_set(ps)),
        [tserde.decode_service_entry(jserde.encode_service_entry(s))
         for s in svcs], topology=_topo(ttopo), device="cpu",
        **{**KW, "canary_probes": 8})
    t.step(_tb(_batch([_pkt(POD_C6, VIP6, 80, sport=44000),
                       _pkt(REMOTE_POD6, POD_B6, 80, sport=44001)], [5, 1])),
           1)
    inc0 = t._drs.ingress.at.inc
    for added, removed in (([REMOTE_POD6], []), ([], [POD_A6])):
        before = t.commit_stats()["canary_probes_total"]
        t.apply_group_delta("bad", added, removed)
        st = t.commit_stats()
        assert st["canary_probes_total"] > before and not st["degraded"]
    assert t._n_deltas >= 2 and t._drs.ingress.at.inc is inc0
    a = t.audit_scan(2, full=True)
    assert a["audited"] > 0 and a["divergences"] == 0


def test_dual_stack_refusals_equal_reference():
    """The JAX engine's dual-stack refusals, as ConfigErrors with its words:
    fused + pruning + dual_stack, async + dual_stack, a tenant world on a
    dual-stack engine; fused + dual_stack without pruning constructs;
    profile() refuses v6 batches with the JAX engine's ValueError."""
    kw = dict(flow_slots=16, aff_slots=16)
    for bad in ({"fused": True, "prune_budget": 2},
                {"async_slowpath": True}):
        with pytest.raises(JConfigError) as je:
            JEngine(dual_stack=True, **kw, **bad)
        with pytest.raises(TConfigError) as te:
            td.TpuflowDatapath(dual_stack=True, device="cpu", **kw, **bad)
        assert str(te.value) == str(je.value)
    j = JEngine(dual_stack=True, fused=True, **kw)
    t = td.TpuflowDatapath(dual_stack=True, fused=True, device="cpu", **kw)
    with pytest.raises(JConfigError) as je:
        j.tenant_create("a")
    with pytest.raises(TConfigError) as te:
        t.tenant_create("a")
    assert str(te.value) == str(je.value)
    b = _batch([_pkt(POD_C6, POD_B6)])
    with pytest.raises(ValueError) as je:
        j.profile(b)
    with pytest.raises(ValueError) as te:
        t.profile(_tb(b))
    assert str(te.value) == str(je.value)
    assert t.step(_tb(b), 1).dnat_key[0] == iputil.ip_to_key(POD_B6)


def test_v4_engine_refuses_a_v6_batch_as_the_reference():
    """tests/test_ipv6_datapath.py:256: a v4-only engine refuses v6 lanes
    loudly (the same ValueError as the JAX engine), dual-stack or not in
    its tables."""
    b = _batch([_pkt("fd00::1", "fd00::2")])
    with pytest.raises(ValueError) as je:
        JEngine(PolicySet(), [], topology=jtopo.Topology()).step(b, 1)
    with pytest.raises(ValueError) as te:
        td.TpuflowDatapath(PolicySet(), [], topology=ttopo.Topology(),
                           device="cpu", flow_slots=16,
                           aff_slots=16).step(_tb(b), 1)
    assert str(te.value) == str(je.value)
