"""Dual-stack in the PyTorch port's classifier and pipeline step, against the
JAX package on the CPU.

The unit cases hold the port's v6 interval search (_searchsorted6), the v6
frontend probe, flow_hash_wide, _wide_words and the family-aware delta
match to their JAX functions on edge inputs: padded bound tables, lanes
equal to a bound, the all-ones and the zero address, an empty table.  Then
the v6 truth tables of tests/test_ipv6.py through both classifiers
(unfused, fused: B1's plain version against the Pallas consumer in
interpret mode, pruned: B2's), and the pipeline cases of tests/test_ipv6.py
and tests/test_ipv6_services.py through both dual-stack pipelines (staged
unfused, staged fused, staged pruned) on one world built once: every output
(the wide DNAT view included), the flow and affinity tables (the dump row
excluded) and pipeline_trace bitwise equal.  Every value is an int32 or u32
word, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antrea_tpu.apis import controlplane as cp
from antrea_tpu.apis.service import ETP_LOCAL, Endpoint, ServiceEntry
from antrea_tpu.compiler.compile import ACT_ALLOW, ACT_DROP
from antrea_tpu.compiler.compile import compile_policy_set as jcompile
from antrea_tpu.compiler.ir import PolicySet
from antrea_tpu.compiler.services import compile_services as jcompile_svc
from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.ops import hashing as jhash
from antrea_tpu.ops import match as jm
from antrea_tpu.packet import Packet, PacketBatch
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.compiler.compile import compile_policy_set as tcompile
from antrea_tpu_torch.compiler.services import compile_services as tcompile_svc
from antrea_tpu_torch.dissemination import serde as tserde
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.ops import hashing as thash
from antrea_tpu_torch.ops import match as tm
import torch_cpu  # noqa: F401  (one torch thread a worker)

_KEYS = ("code", "egress_code", "egress_rule", "ingress_code", "ingress_rule")

WEB6 = EP6A = "2001:db8:0:1::10"
EP6B = "2001:db8:0:1::11"
CLIENT6 = "2001:db8:0:2::7"
OTHER6 = "2001:db8:ffff::9"
WEB4 = EP4 = "10.0.0.10"
CLIENT4 = "10.0.1.7"
NODE4, NODE6 = "192.168.0.1", "2001:db8:ffff::1"
EXT6, EXT6L = "fd00:ee::5", "fd00:ee::6"


def _t(a) -> torch.Tensor:
    """numpy u32/i32 -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32))


def _pkt(src, dst, dport=80, proto=6, sport=40000):
    return Packet(src_ip=iputil.ip_to_key(src), dst_ip=iputil.ip_to_key(dst),
                  proto=proto, src_port=sport, dst_port=dport)


def _cols(b):
    """A batch's (src_f, dst_f, proto, sport, dport) and v6 lanes, numpy."""
    cols = (iputil.flip_u32(b.src_ip), iputil.flip_u32(b.dst_ip),
            b.proto.astype(np.int32), b.src_port.astype(np.int32),
            b.dst_port.astype(np.int32))
    v6 = (iputil.flip_u32(b.src_ip6), iputil.flip_u32(b.dst_ip6),
          b.is6.astype(np.int32))
    return cols, v6


def _port_ps(ps):
    return tserde.decode_policy_set(jserde.encode_policy_set(ps))


def _port_svcs(svcs):
    return [tserde.decode_service_entry(jserde.encode_service_entry(s))
            for s in svcs]


def _words(vals) -> np.ndarray:
    """v6-relative ints -> (N, 4) flipped int32 words."""
    return np.array([iputil.key_to_flipped_words(iputil.V6_OFF + v)
                     for v in vals], np.int32).reshape(-1, 4)


def _edge_lanes(bounds6: np.ndarray, rng) -> np.ndarray:
    """Lanes at, just below and just above every bound (the last word moved
    by one, wrapping into the word before at its ends), the all-ones and the
    zero address, and random addresses."""
    b = np.asarray(bounds6, np.int64).reshape(-1, 4)
    out = [b]
    for d in (-1, 1):
        m = b.copy()
        m[:, 3] += d
        over = m[:, 3] > 2**31 - 1
        under = m[:, 3] < -(2**31)
        m[over, 3], m[under, 3] = -(2**31), 2**31 - 1
        m[over, 2] += 1
        m[under, 2] -= 1
        out.append(np.clip(m, -(2**31), 2**31 - 1))
    out.append(np.full((2, 4), 2**31 - 1))
    out.append(np.full((2, 4), -(2**31)))
    out.append(rng.integers(-(2**31), 2**31, (64, 4)))
    return np.concatenate(out).astype(np.int32)


# ---------------------------------------------------------------------------
# Unit cases
# ---------------------------------------------------------------------------


def test_searchsorted6_equals_reference():
    """The port's binary search against the JAX all-pairs count: real
    bounds, the same padded to the cap6 rung (pad rows are the all-ones
    address), a single bound, a non-power-of-two count, no bounds."""
    rng = np.random.default_rng(3)
    vals = sorted({int(x) << 64 | int(y) for x, y in
                   zip(rng.integers(0, 2**63, 37), rng.integers(0, 8, 37))})
    real = _words(vals)
    tab = tm.DimTable(bounds=np.zeros(0, np.int32), bounds6=real,
                      inc=np.zeros((len(vals) + 2, 1), np.uint32))
    padded = tm._pad_dim_table(tab, 0, tm._entry_cap(len(vals))).bounds6
    assert padded.shape[0] == 64 and (padded[-1] == 2**31 - 1).all()
    for bounds in (real, padded, real[:1], real[:5],
                   np.zeros((0, 4), np.int32)):
        xw = _edge_lanes(real, rng)
        got = tm._searchsorted6(_t(bounds), _t(xw))
        want = jm._searchsorted6(jnp.asarray(bounds), jnp.asarray(xw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tm._searchsorted6(_t(padded), _t(np.full((1, 4), 2**31 - 1,
                                                        np.int32)))[0]) == 64
    # _dim_index's v6 branch: v4 lanes in the v4 sub-space, v6 lanes past
    # it; and the six tables of lane_rows in one search.
    xw = _edge_lanes(real, rng)
    n = xw.shape[0]
    b4 = np.sort(rng.integers(-(2**31), 2**31, 9)).astype(np.int32)
    x = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    is6 = rng.integers(0, 2, n).astype(np.int32)
    for bounds in (padded, np.zeros((0, 4), np.int32)):
        got = tm._dim_index(tm.DimTable(_t(b4), _t(bounds), None), _t(x),
                            _t(xw), _t(is6))
        want = jm._dim_index(jm.DimTable(jnp.asarray(b4), jnp.asarray(bounds),
                                         None), jnp.asarray(x),
                             jnp.asarray(xw), jnp.asarray(is6))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    many = tm._searchsorted6_many([_t(real), _t(padded), _t(real[:3])],
                                  [_t(xw)] * 3)
    for got, bounds in zip(many, (real, padded, real[:3])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jm._searchsorted6(jnp.asarray(bounds), jnp.asarray(xw))))


def test_lex_le4_and_delta_lane_match_equal_reference():
    """_lex_le4 and the family-aware delta match, slot by slot and all
    slots at once, on lanes sharing long word prefixes with the slots'
    bounds; without `wide` the narrow test is unchanged."""
    rng = np.random.default_rng(5)
    lo6 = rng.integers(-3, 3, (6, 4)).astype(np.int32)
    hi6 = lo6 + rng.integers(0, 3, (6, 4)).astype(np.int32)
    xw = rng.integers(-4, 5, (256, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tm._lex_le4(_t(lo6[:1]), _t(xw)).numpy(),
        np.asarray(jm._lex_le4(jnp.asarray(lo6[:1]), jnp.asarray(xw))))
    d = jm.empty_delta(6, 1, 1)
    d = d._replace(
        lo_f=np.array([-5, 0, 2, -9, 3, 1], np.int32),
        hi_f=np.array([5, 0, 9, -1, 3, 4], np.int32),
        sign=np.array([1, -1, 1, 1, -1, 1], np.int32),
        fam=np.array([0, 1, 1, 0, 1, 0], np.int32), lo6_w=lo6, hi6_w=hi6,
        n=np.int32(6))
    td = tm.from_numpy(tm.DeltaTable, d, "cpu")
    jd = jax.tree_util.tree_map(jnp.asarray, d)
    ip = rng.integers(-10, 10, 256).astype(np.int32)
    is6 = rng.integers(0, 2, 256).astype(np.int32)
    for wide in (False, True):
        tw = (_t(xw), _t(is6)) if wide else None
        jw = (jnp.asarray(xw), jnp.asarray(is6)) if wide else None
        allm = tm._delta_matches(_t(ip), td, 6, tw).numpy()
        for i in range(6):
            want = np.asarray(jm._delta_lane_match(jnp.asarray(ip), jd, i, jw))
            np.testing.assert_array_equal(
                tm._delta_lane_match(_t(ip), td, i, tw).numpy(), want)
            np.testing.assert_array_equal(allm[:, i], want)
        assert allm.any() and not allm.all()


def test_flow_hash_wide_and_wide_words_equal_reference():
    rng = np.random.default_rng(7)
    n = 512
    words = rng.integers(-(2**31), 2**31, (n, 8)).astype(np.int32)
    words[:4] = 2**31 - 1
    words[4:8] = -(2**31)
    proto = rng.choice([1, 6, 17, 255], n).astype(np.int32)
    sport, dport = (rng.integers(0, 65536, n).astype(np.int32)
                    for _ in range(2))
    got = thash.flow_hash_wide([_t(words[:, i]) for i in range(8)],
                               _t(proto), _t(sport), _t(dport))
    want = jhash.flow_hash_wide([jnp.asarray(words[:, i]) for i in range(8)],
                                jnp.asarray(proto), jnp.asarray(sport),
                                jnp.asarray(dport), xp=jnp)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    col = words[:, 0]
    is6 = rng.integers(0, 2, n).astype(np.int32)
    for w6 in (None, words[:, 4:]):
        got = tpl._wide_words(_t(col), None if w6 is None else _t(w6),
                              _t(is6))
        want = jpl._wide_words(jnp.asarray(col),
                               None if w6 is None else jnp.asarray(w6),
                               jnp.asarray(is6))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tpl._MAP0, tpl._MAPF) == (jpl._MAP0, jpl._MAPF)


def test_v6_frontend_probe_equals_reference():
    """The wide ServiceLB (its v6 frontend search, the wide affinity and
    DNAT) against the JAX package's all-pairs probe: lanes at every v6
    frontend, next to each, the all-ones and zero addresses, v4 lanes whose
    narrow column equals a v4 frontend, on a table of 40 v6 frontends with
    several ports each."""
    svcs = []
    for i in range(40):
        for port in (80, 443):
            svcs.append(ServiceEntry(
                cluster_ip=f"fd00:96::{i * 7919 >> 16:x}:{i * 7919 & 0xFFFF:x}",
                port=port, protocol=6,
                endpoints=[Endpoint(f"2001:db8:1::{i:x}", 8080 + port)]
                if i % 5 else [],
                affinity_timeout_s=300 if i % 3 == 0 else 0))
    svcs.append(ServiceEntry(cluster_ip="10.96.0.1", port=80, protocol=6,
                             endpoints=[Endpoint("10.0.0.5", 8080)]))
    jsvc = jcompile_svc(svcs)
    tsvc = tcompile_svc(_port_svcs(svcs))
    jd = jpl.svc_to_device(jsvc)
    td = tpl.svc_to_device(tsvc, "cpu")
    rng = np.random.default_rng(9)
    daddr = _edge_lanes(np.asarray(jsvc.uip6_w), rng)
    n = daddr.shape[0]
    is6 = np.ones(n, np.int32)
    is6[-8:] = 0
    dst = np.full(n, int(iputil.flip_u32(np.uint32(
        iputil.ip_to_u32("10.96.0.1")))), np.int32)
    saddr = rng.integers(-(2**31), 2**31, (n, 4)).astype(np.int32)
    src = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    proto = np.full(n, 6, np.int32)
    dport = rng.choice([80, 443, 22], n).astype(np.int32)
    h = rng.integers(0, 2**31, n).astype(np.int32)
    jst = jpl.init_state(16, 64, key_words=10)
    tst = tpl.init_state(16, 64, device="cpu", key_words=10)
    got = tpl._service_lb(tst.aff, td, _t(h).long(), _t(src), _t(dst),
                          _t(proto), _t(dport), 5, 64,
                          wide=(_t(saddr), _t(daddr), _t(is6)))
    want = jpl._service_lb(jst.aff, jd, jnp.asarray(h).astype(jnp.uint32),
                           jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(proto), jnp.asarray(dport),
                           jnp.int32(5), 64,
                           wide=tuple(jnp.asarray(x) for x in
                                      (saddr, daddr, is6)))
    for k, (g, w) in enumerate(zip(got[:7], want[:7])):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=str(k))
    for key in ("mask", "aslot", "client", "svc", "ep"):
        np.testing.assert_array_equal(
            got[7][key].numpy().astype(np.int64),
            np.asarray(want[7][key]).astype(np.int64), err_msg=key)
    # The exact frontend lanes on a frontend port hit, the others miss.
    svc = got[0].numpy()
    on_port = np.isin(dport[:40], (80, 443))
    assert (svc[:40][on_port] >= 0).all() and (svc[40:] == -1).any()


# ---------------------------------------------------------------------------
# Classify truth tables (tests/test_ipv6.py:70, 93, 118, 135, 169)
# ---------------------------------------------------------------------------


def _member(ip):
    return cp.GroupMember(ip=ip, node="n0")


def _web_ps(*ips):
    ps = PolicySet()
    ps.applied_to_groups["web"] = cp.AppliedToGroup(
        name="web", members=[_member(ip) for ip in ips])
    return ps


def _acnp(ps, uid, groups, rule, tier=250, prio=1.0):
    ps.policies.append(cp.NetworkPolicy(
        uid=uid, name=uid, type=cp.NetworkPolicyType.ACNP,
        applied_to_groups=groups, tier_priority=tier, priority=prio,
        rules=[rule]))


def _truth_v6_cidr_peer():
    ps = _web_ps(WEB6)
    _acnp(ps, "p", ["web"], cp.NetworkPolicyRule(
        direction=cp.Direction.IN,
        from_peer=cp.NetworkPolicyPeer(
            ip_blocks=[cp.IPBlock("2001:db8:0:2::/64")]),
        action=cp.RuleAction.DROP, priority=0))
    return ps, [(CLIENT6, WEB6, 80, ACT_DROP), (OTHER6, WEB6, 80, ACT_ALLOW),
                (CLIENT4, WEB4, 80, ACT_ALLOW)]


def _truth_k8s_isolation():
    ps = _web_ps(WEB6, WEB4)
    ps.address_groups["cli6"] = cp.AddressGroup(
        name="cli6", ip_blocks=[cp.IPBlock("2001:db8:0:2::/64")])
    ps.policies.append(cp.NetworkPolicy(
        uid="k", name="k", namespace="ns", type=cp.NetworkPolicyType.K8S,
        applied_to_groups=["web"], policy_types=[cp.Direction.IN],
        rules=[cp.NetworkPolicyRule(
            direction=cp.Direction.IN,
            from_peer=cp.NetworkPolicyPeer(address_groups=["cli6"]))]))
    return ps, [(CLIENT6, WEB6, 80, ACT_ALLOW), (OTHER6, WEB6, 80, ACT_DROP),
                (CLIENT4, WEB4, 80, ACT_DROP),
                (CLIENT4, "10.0.0.99", 80, ACT_ALLOW)]


def _truth_any_peer():
    ps = _web_ps(WEB6, WEB4)
    ps.policies.append(cp.NetworkPolicy(
        uid="k", name="k", namespace="ns", type=cp.NetworkPolicyType.K8S,
        applied_to_groups=["web"], policy_types=[cp.Direction.IN],
        rules=[cp.NetworkPolicyRule(direction=cp.Direction.IN)]))
    return ps, [(OTHER6, WEB6, 80, ACT_ALLOW), (CLIENT4, WEB4, 80, ACT_ALLOW)]


def _truth_member_peers_and_egress():
    ps = PolicySet()
    ps.applied_to_groups["cli"] = cp.AppliedToGroup(
        name="cli", members=[_member(CLIENT6)])
    ps.address_groups["dst"] = cp.AddressGroup(name="dst",
                                               members=[_member(WEB6)])
    _acnp(ps, "drop", ["cli"], cp.NetworkPolicyRule(
        direction=cp.Direction.OUT,
        to_peer=cp.NetworkPolicyPeer(address_groups=["dst"]),
        action=cp.RuleAction.DROP, priority=0), prio=5.0)
    _acnp(ps, "allow", ["cli"], cp.NetworkPolicyRule(
        direction=cp.Direction.OUT,
        to_peer=cp.NetworkPolicyPeer(address_groups=["dst"]),
        services=[cp.Service(protocol=6, port=443)],
        action=cp.RuleAction.ALLOW, priority=0), tier=100)
    return ps, [(CLIENT6, WEB6, 443, ACT_ALLOW), (CLIENT6, WEB6, 80, ACT_DROP),
                (CLIENT6, OTHER6, 80, ACT_ALLOW)]


def _truth_excepts_mixed():
    ps = _web_ps(WEB6, WEB4)
    _acnp(ps, "p", ["web"], cp.NetworkPolicyRule(
        direction=cp.Direction.IN,
        from_peer=cp.NetworkPolicyPeer(ip_blocks=[
            cp.IPBlock("2001:db8::/32", excepts=("2001:db8:0:2::/64",)),
            cp.IPBlock("10.0.1.0/24")]),
        action=cp.RuleAction.DROP, priority=0))
    return ps, [(OTHER6, WEB6, 80, ACT_DROP), (CLIENT6, WEB6, 80, ACT_ALLOW),
                (CLIENT4, WEB4, 80, ACT_DROP),
                ("10.0.2.7", WEB4, 80, ACT_ALLOW)]


@pytest.mark.parametrize("case", [
    _truth_v6_cidr_peer, _truth_k8s_isolation, _truth_any_peer,
    _truth_member_peers_and_egress, _truth_excepts_mixed])
def test_v6_truth_tables_equal_reference(case):
    """Each truth table of tests/test_ipv6.py through the JAX classifier
    and the port's, unfused, fused (B1's plain version) and pruned (K = 2,
    B2's plain version; summary_only too): every output bitwise equal, and
    the expected verdicts."""
    ps, cases = case()
    b = PacketBatch.from_packets([_pkt(s, d, dp) for s, d, dp, _ in cases])
    cols, v6 = _cols(b)
    cols4 = cols[:3] + cols[4:]
    jfn, _ = jm.make_classifier(jcompile(ps))
    want = jfn(*(jnp.asarray(c) for c in cols4),
               v6=tuple(jnp.asarray(x) for x in v6))
    np.testing.assert_array_equal(np.asarray(want["code"]),
                                  [e for *_, e in cases])
    tcps = tcompile(_port_ps(ps))
    tv6 = tuple(_t(x) for x in v6)
    for prune, fused in ((0, False), (0, True), (2, True), (2, False)):
        drs, meta = tm.to_device(tcps, "cpu", prune_budget=prune)
        got = tm.classify_batch(drs, *(_t(c) for c in cols4), meta=meta,
                                fused=fused, v6=tv6)
        for key in _KEYS:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"{key} K={prune}")
    # summary_only runs with v6 lanes and equals the JAX package's.
    jdrs, jmeta = jm.to_device(jcompile(ps), prune_budget=2)
    jsum = jm.classify_batch(jdrs, *(jnp.asarray(c) for c in cols4),
                             meta=jmeta, summary_only=True,
                             v6=tuple(jnp.asarray(x) for x in v6))
    tsum = tm.classify_batch(drs, *(_t(c) for c in cols4), meta=meta,
                             summary_only=True, v6=tv6)
    for key in _KEYS + ("prune_skip", "prune_fb", "prune_cand"):
        np.testing.assert_array_equal(tsum[key].numpy(), np.asarray(jsum[key]),
                                      err_msg=f"summary_only {key}")


# ---------------------------------------------------------------------------
# The dual-stack pipeline (tests/test_ipv6.py:266, 296, 337, 426 and
# tests/test_ipv6_services.py:105-263), on one world built once
# ---------------------------------------------------------------------------

LANES = 32
VIP6 = "fd00:96::10"  # -> EP6A
VIP6_AFF = "fd00:96::11"  # affinity over EP6A, EP6B
VIP6_NOEP = "fd00:96::12"
VIP6_NP = "fd00:96::13"  # NodePort 30080 on the v6 node IP
VIP6_DSR = "fd00:96::14"  # external EXT6, DSR
VIP6_ETP = "fd00:96::15"  # external EXT6L, ETP=Local, endpoint elsewhere
VIP4 = "10.96.0.10"  # -> EP4
VIP4B = "10.96.7.1"
V4_HOSTS = [f"10.7.{i}.{j}" for i in range(2) for j in range(1, 5)]
V6_HOSTS = [f"2001:db8:7:{i}::{j}" for i in range(2) for j in range(1, 5)]
MODES = {"staged": {}, "fused": {"fused": True},
         "pruned": {"fused": True, "prune_budget": 2}}


def _pipe_world():
    """test_ipv6.py's _dual_ps (a v6 and a v4 drop block onto a dual-stack
    web group, whose v6 member is also the v6 Services' endpoint: the
    post-DNAT policy case) and the Services of test_ipv6_services.py."""
    ps = _web_ps(WEB6, WEB4)
    _acnp(ps, "p", ["web"], cp.NetworkPolicyRule(
        direction=cp.Direction.IN,
        from_peer=cp.NetworkPolicyPeer(ip_blocks=[
            cp.IPBlock("2001:db8:0:2::/64"), cp.IPBlock("10.0.1.0/24")]),
        action=cp.RuleAction.DROP, priority=0))
    svcs = [
        ServiceEntry(cluster_ip=VIP6, port=80, protocol=6,
                     endpoints=[Endpoint(EP6A, 8080)]),
        ServiceEntry(cluster_ip=VIP6_AFF, port=80, protocol=6,
                     endpoints=[Endpoint(EP6A, 8080), Endpoint(EP6B, 8080)],
                     affinity_timeout_s=300),
        ServiceEntry(cluster_ip=VIP6_NOEP, port=80, protocol=6, endpoints=[]),
        ServiceEntry(cluster_ip=VIP6_NP, port=80, protocol=6,
                     endpoints=[Endpoint(EP6A, 8080)], node_port=30080),
        ServiceEntry(cluster_ip=VIP6_DSR, port=80, protocol=6,
                     endpoints=[Endpoint(EP6A, 80)], external_ips=[EXT6],
                     dsr=True),
        ServiceEntry(cluster_ip=VIP6_ETP, port=80, protocol=6,
                     endpoints=[Endpoint(EP6A, 8080, node="other")],
                     external_ips=[EXT6L],
                     external_traffic_policy=ETP_LOCAL),
        ServiceEntry(cluster_ip=VIP4, port=80, protocol=6,
                     endpoints=[Endpoint(EP4, 8080)]),
        ServiceEntry(cluster_ip=VIP4B, port=80, protocol=6,
                     endpoints=[Endpoint(V4_HOSTS[0], 8080)]),
    ]
    return ps, svcs


@pytest.fixture(scope="module")
def pipes():
    """Per mode: the JAX dual-stack pipeline and the port's, built once."""
    ps, svcs = _pipe_world()
    kw = dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=16,
              dual_stack=True)
    node = dict(node_ips=[NODE4, NODE6], node_name="n0")
    jcps, jsvc = jcompile(ps), jcompile_svc(svcs, **node)
    tcps = tcompile(_port_ps(ps))
    tsvc = tcompile_svc(_port_svcs(svcs), **node)
    out = {}
    for mode, knobs in MODES.items():
        j = jpl.make_pipeline(jcps, jsvc, **kw, **knobs)
        t = tpl.make_pipeline(tcps, tsvc, device="cpu", **kw, **knobs)
        assert not j[0].meta.onepass and not t[0].meta.onepass
        assert t[0].meta.key_words == j[0].meta.key_words == 10
        out[mode] = (j, t)
    return out


class _Pair:
    """A JAX pipeline and the port's from one fresh state, stepped in
    lockstep on padded LANES-lane batches; every output and both tables
    compared after every step."""

    def __init__(self, pipes, mode):
        (jstep, _, (self.jdrs, self.jdsvc)), (tstep, _, (self.tdrs,
                                                        self.tdsvc)) = (
            pipes[mode])
        self.jmeta, self.tmeta = jstep.meta, tstep.meta
        self.js = jpl.init_state(1 << 10, 1 << 6, key_words=10)
        self.ts = tpl.init_state(1 << 10, 1 << 6, device="cpu",
                                 key_words=10)

    @staticmethod
    def batch(pkts, flags=None):
        """Pad to LANES with lanes of an unused flow (repeats of one tuple,
        so they commit one entry pair)."""
        pad = [_pkt("10.9.9.9", "10.9.9.8", 9, sport=9)] * (LANES - len(pkts))
        b = PacketBatch.from_packets(list(pkts) + pad)
        f = np.zeros(LANES, np.int32)
        if flags is not None:
            f[:len(flags)] = flags
        return b, f

    def step(self, pkts, now, gen=0, flags=None):
        b, f = self.batch(pkts, flags)
        cols, v6 = _cols(b)
        self.js, jo = jpl.pipeline_step(
            self.js, self.jdrs, self.jdsvc, *(jnp.asarray(c) for c in cols),
            jnp.int32(now), jnp.int32(gen), meta=self.jmeta,
            v6=tuple(jnp.asarray(x) for x in v6), flags=jnp.asarray(f))
        self.ts, to = tpl.pipeline_step(
            self.ts, self.tdrs, self.tdsvc, *(_t(c) for c in cols), now, gen,
            meta=self.tmeta, v6=tuple(_t(x) for x in v6), flags=_t(f))
        jo = jax.device_get(jo)
        assert set(to) == set(jo) and "dnat_w_f" in to
        for k in jo:
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                          err_msg=f"now={now} out[{k}]")
        js = jax.device_get(self.js)
        for part in ("flow", "aff"):
            for f_, tt in zip(getattr(js, part)._fields,
                              getattr(self.ts, part)):
                np.testing.assert_array_equal(
                    tt.numpy()[:-1], np.asarray(getattr(getattr(js, part),
                                                        f_))[:-1],
                    err_msg=f"now={now} {part}.{f_}")
        return {k: v.numpy()[:len(pkts)] for k, v in to.items()
                if v.dim()}

    def wide_rows(self, now, gen):
        """What works on slots and rows only, on the wide rows: the cache
        census, the state digest, an audit window, the fused maintenance
        scan (which clears the v6 denials of another generation)."""
        js = jax.device_get(self.js)
        assert {k: int(v) for k, v in tpl.cache_stats(self.ts).items()} == {
            k: int(v) for k, v in jpl.cache_stats(self.js).items()}
        assert tpl.tensor_digest(tpl.tree_leaves(self.ts)) == (
            jpl.tensor_digest(jax.tree_util.tree_leaves(js)))
        for got, want in zip(tpl.audit_gather(self.ts, 5, window=64),
                             jpl.audit_gather(self.js, jnp.int32(5),
                                              window=64)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        self.ts, ta, tr = tpl._maintain_scan(self.ts, now, gen,
                                             timeouts=self.tmeta.timeouts)
        self.js, ja, jr = jpl.maintain_scan(self.js, jnp.int32(now),
                                            jnp.int32(gen),
                                            timeouts=self.jmeta.timeouts)
        assert (int(ta), int(tr)) == (int(ja), int(jr)) and int(jr) > 0
        np.testing.assert_array_equal(self.ts.flow.keys.numpy(),
                                      np.asarray(self.js.flow.keys))

    def trace(self, pkts, now, gen=0):
        b, _ = self.batch(pkts)
        cols, v6 = _cols(b)
        jo = jpl.pipeline_trace(
            self.js, self.jdrs, self.jdsvc, *(jnp.asarray(c) for c in cols),
            jnp.int32(now), jnp.int32(gen), meta=self.jmeta,
            v6=tuple(jnp.asarray(x) for x in v6))
        to = tpl.pipeline_trace(
            self.ts, self.tdrs, self.tdsvc, *(_t(c) for c in cols), now, gen,
            meta=self.tmeta, v6=tuple(_t(x) for x in v6))
        assert set(to) == set(jo) and "cached_dnat_w_f" in to
        for k in jo:
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                          err_msg=f"trace {k}")


def _key(words) -> int:
    """Wide DNAT words -> combined-keyspace int."""
    w = [iputil.unflip_u32(int(x)) for x in words]
    v = (w[0] << 96) | (w[1] << 64) | (w[2] << 32) | w[3]
    return v & 0xFFFFFFFF if (v >> 32) == 0xFFFF else iputil.V6_OFF + v


@pytest.mark.parametrize("mode", list(MODES))
def test_dual_stack_conntrack_equals_reference(pipes, mode):
    """tests/test_ipv6.py:266, 296 and 337: a mixed batch commits and
    caches denials, est-hits, the v6 reply leg; a generation bump
    reclassifies the v6 denial, FIN tears the v6 connection down; v4
    Service DNAT and its reply un-DNAT over wide keys."""
    p = _Pair(pipes, mode)
    mixed = [_pkt(OTHER6, WEB6, sport=41000), _pkt(CLIENT6, WEB6, sport=41001),
             _pkt("10.9.9.9", WEB4, sport=41002),
             _pkt("10.0.1.7", WEB4, sport=41003),
             _pkt("10.9.9.7", VIP4, 80, sport=43000)]
    o = p.step(mixed, 1)
    assert list(o["code"]) == [0, 1, 0, 1, 0]
    assert list(o["committed"]) == [1, 0, 1, 0, 1]
    assert int(o["dnat_port"][4]) == 8080
    assert _key(o["dnat_w_f"][4]) == iputil.ip_to_u32(EP4)
    o = p.step(mixed, 2)
    assert list(o["est"]) == [1, 0, 1, 0, 1] and not o["miss"].any()
    rev = [Packet(iputil.ip_to_key(WEB6), iputil.ip_to_key(OTHER6), 6, 80,
                  41000),
           Packet(iputil.ip_to_u32(EP4), iputil.ip_to_u32("10.9.9.7"), 6,
                  8080, 43000)]
    o = p.step(rev, 3)
    assert list(o["reply"]) == [1, 1] and int(o["dnat_port"][1]) == 80
    o = p.step(mixed[:2], 4, gen=1)
    assert list(o["miss"]) == [0, 1] and list(o["code"]) == [0, 1]
    p.step(mixed[:1], 5, gen=1, flags=[jpl.TCP_FIN])
    o = p.step(mixed[:1], 6, gen=1)
    assert int(o["miss"][0]) == 1 and int(o["est"][0]) == 0
    p.trace(mixed + rev, 7, gen=1)
    p.wide_rows(9, 2)


@pytest.mark.parametrize("mode", list(MODES))
def test_v6_services_equal_reference(pipes, mode):
    """tests/test_ipv6_services.py:105, 134, 157, 168, 186, 206, 226 and
    263: v6 ClusterIP DNAT and its reply un-DNAT, ClientIP affinity on the
    128-bit client, no-endpoint reject, NodePort on the v6 node IP only,
    DSR on a v6 external IP (no reply leg), ETP=Local, twin Services of
    both families in one batch, policy on the post-DNAT v6 tuple."""
    p = _Pair(pipes, mode)
    first = [
        _pkt(OTHER6, VIP6, 80, sport=43000),
        _pkt(CLIENT6, VIP6_AFF, 80, sport=43100),
        _pkt(CLIENT6, VIP6_NOEP, 80, sport=43150),
        _pkt(OTHER6, NODE6, 30080, sport=43200),
        _pkt(CLIENT4, NODE4, 30080, sport=43201),
        _pkt(OTHER6, EXT6, 80, sport=43300),
        _pkt(OTHER6, EXT6L, 80, sport=43400),
        _pkt(OTHER6, VIP6_ETP, 80, sport=43401),
        _pkt("10.9.9.9", VIP4, 80, sport=43501),
        _pkt(CLIENT6, VIP6, 80, sport=43600),
    ]
    o = p.step(first, 1)
    assert _key(o["dnat_w_f"][0]) == iputil.ip_to_key(EP6A)
    assert int(o["dnat_port"][0]) == 8080
    assert list(o["code"][[2, 6]]) == [2, 2]  # no endpoint, ETP=Local
    assert int(o["snat"][3]) == 1 and int(o["svc_idx"][4]) == -1
    assert int(o["dsr"][5]) == 1 and int(o["snat"][5]) == 0
    assert int(o["code"][7]) == 0 and int(o["code"][9]) == 1
    aff = _key(o["dnat_w_f"][1])
    for sport in (43101, 43102):
        o = p.step([_pkt(CLIENT6, VIP6_AFF, 80, sport=sport)], sport - 43090)
        assert _key(o["dnat_w_f"][0]) == aff
    rev = [Packet(iputil.ip_to_key(EP6A), iputil.ip_to_key(OTHER6), 6, 8080,
                  43000),
           Packet(iputil.ip_to_key(EP6A), iputil.ip_to_key(OTHER6), 6, 80,
                  43300)]
    o = p.step(rev, 20)
    assert list(o["reply"]) == [1, 0]
    assert _key(o["dnat_w_f"][0]) == iputil.ip_to_key(VIP6)
    p.trace(first + rev, 21)


def test_dual_stack_randomized_equals_reference(pipes):
    """tests/test_ipv6.py:426: a seeded mixed-family flow universe with
    replies, FIN lanes, a v4 Service and a generation bump, 6 steps through
    the staged pruned pipelines (B2's and B1's plain versions)."""
    rng = np.random.default_rng(7)
    p = _Pair(pipes, "pruned")
    flows = []
    for _ in range(24):
        hosts = V6_HOSTS if rng.random() < 0.5 else V4_HOSTS
        s, d = rng.choice(hosts, 2, replace=False)
        if hosts is V4_HOSTS and rng.random() < 0.3:
            d = VIP4B
        flows.append(_pkt(str(s), str(d), 80,
                          sport=int(rng.integers(40000, 40020))))
    for t in range(6):
        pkts = []
        for i in rng.integers(0, len(flows), LANES):
            f = flows[i]
            if rng.random() < 0.3:
                f = Packet(f.dst_ip, f.src_ip, 6, f.dst_port, f.src_port)
            pkts.append(f)
        flags = (rng.random(LANES) < 0.05).astype(np.int32) * jpl.TCP_FIN
        p.step(pkts, 10 + t, gen=int(t >= 3), flags=flags)


def test_family_mismatch_raises_on_both_compilers():
    """tests/test_ipv6_services.py:248: a Service whose endpoints or
    external IPs are of the other family is refused by both compilers."""
    bad_ep = ServiceEntry(cluster_ip=VIP6, port=80, protocol=6,
                          endpoints=[Endpoint(EP4, 8080)])
    bad_ext = ServiceEntry(cluster_ip=VIP4, port=80, protocol=6,
                           endpoints=[Endpoint(EP4, 8080)],
                           external_ips=[EXT6])
    for bad in (bad_ep, bad_ext):
        with pytest.raises(ValueError) as je:
            jcompile_svc([bad])
        with pytest.raises(ValueError) as te:
            tcompile_svc(_port_svcs([bad]))
        assert str(te.value) == str(je.value)


def test_v6_lanes_on_a_v4_pipeline_raise_as_the_reference(pipes):
    ps, svcs = _pipe_world()
    t = tpl.make_pipeline(tcompile(_port_ps(ps)), tcompile_svc(
        _port_svcs(svcs)), flow_slots=16, aff_slots=16, device="cpu")
    (step, state, (drs, dsvc)) = t
    lanes = [torch.zeros(4, dtype=torch.int32)] * 5
    v6 = (torch.zeros((4, 4), dtype=torch.int32),) * 2 + (
        torch.ones(4, dtype=torch.int32),)
    with pytest.raises(ValueError, match="dual_stack"):
        step(state, drs, dsvc, *lanes, 1, 0, v6=v6)
    with pytest.raises(ValueError, match="dual_stack"):
        tpl.pipeline_trace(state, drs, dsvc, *lanes, 1, 0, meta=step.meta,
                           v6=v6)
    # The one-pass step is v4-only: asked for on wide keys, it raises.
    d = tpl.make_pipeline(tcompile(_port_ps(ps)), tcompile_svc(
        _port_svcs(svcs)), flow_slots=16, aff_slots=16, device="cpu",
        dual_stack=True, fused=True, prune_budget=2, onepass=True)
    with pytest.raises(ValueError, match="onepass"):
        d[0](d[1], *d[2], *lanes, 1, 0, v6=v6)
