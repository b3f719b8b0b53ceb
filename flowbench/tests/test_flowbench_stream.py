"""The traffic generator: the same seed gives the same batches and another
seed others; every step opens connections never seen before; a reply
follows its connection's first packet and comes only for classes that
reply; a lane enters at its source's port; policy_in connections are the
ones the policy admits."""

import copy

import numpy as np
import pytest

from conftest import SMALL_MIX, small_config
from flowbench.reference.datapath import Replay
from flowbench.stream import OFPORT_GATEWAY, OFPORT_TUNNEL, Stream
from flowbench.world import build_world, plain_world

COLS = ("src_ip", "dst_ip", "proto", "src_port", "dst_port")


@pytest.fixture(scope="module", params=["small_ns", "one_ns"])
def plain(request):
    return plain_world(build_world(small_config(request.param)))


def _tuples(cols, lo=0, hi=None):
    return set(zip(*(cols[k][lo:hi].tolist() for k in COLS)))


def test_same_seed_same_batches(plain):
    a, b = Stream(SMALL_MIX, plain, 2**33 + 1), Stream(SMALL_MIX, plain,
                                                       2**33 + 1)
    c = Stream(SMALL_MIX, plain, 2**33 + 2)
    for t in (0, 5, 17):
        ca, cb, cc = a.columns(t), b.columns(t), c.columns(t)
        assert all(np.array_equal(ca[k], cb[k]) for k in ca)
        assert not np.array_equal(ca["src_port"], cc["src_port"])


def test_connections_are_new_and_replies_follow_them(plain):
    s = Stream(SMALL_MIX, plain, 11)
    n, life = s.new, s.life
    seen, forward = set(), {}
    for t in range(3 * s.period + 2):
        cols = s.columns(t)
        first = _tuples(cols, 0, n)
        # Every step opens connections no earlier step sent (over several
        # passes over the templates).
        assert len(first & seen) <= 1, t
        for i, tup in enumerate(zip(*(cols[k][:n].tolist()
                                      for k in COLS))):
            forward[tup] = t
        seen |= _tuples(cols)
        if t < life:
            continue
        rep = s.templates[t % s.period]["reply"].astype(bool)
        later = [tuple(cols[k][i] for k in COLS) for i in
                 np.nonzero(~rep[n:])[0] + n]
        back = [(cols["dst_ip"][i], cols["src_ip"][i], cols["proto"][i],
                 cols["dst_port"][i], cols["src_port"][i])
                for i in np.nonzero(rep)[0]]
        # A later packet is its connection's first packet again or its
        # reply, of a connection opened within life_steps steps before.
        for tup in later + back:
            tup = tuple(int(x) for x in tup)
            assert t - life <= forward[tup] < t, (t, tup)


def test_replies_only_for_classes_that_reply(plain):
    mix = copy.deepcopy(SMALL_MIX)
    for k in mix["classes"]:
        k["replies"] = False
    s = Stream(mix, plain, 3)
    assert not any(T["reply"].any() for T in s.templates)
    s = Stream(SMALL_MIX, plain, 3)
    share = np.mean([T["reply"][s.new:].mean() for T in s.templates])
    # reply_share of the later packets of the classes that reply (0.9 of
    # the connections).
    assert 0.35 < share < 0.55


def test_ingress_ports_are_the_sources(plain):
    s = Stream(SMALL_MIX, plain, 5)
    cols = s.columns(9)
    local = {int(np.uint32(int.from_bytes(bytes(map(int, ip.split("."))),
                                          "big"))): p
             for ip, p in plain["topology"]["local_pods"]}
    pods = set(np.asarray(plain["pod_ips"]).tolist())
    for src, port in zip(cols["src_ip"].tolist(), cols["in_port"].tolist()):
        want = local.get(src, OFPORT_TUNNEL if src in pods
                         else OFPORT_GATEWAY)
        assert port == want


def test_policy_in_connections_are_admitted(plain):
    mix = copy.deepcopy(SMALL_MIX)
    mix["classes"] = [{"name": "admitted_in", "kind": "policy_in",
                       "share": 1, "replies": False}]
    s = Stream(mix, plain, 8)
    ref = Replay(plain, "cpu")
    o = ref.step(ref.lanes(s.columns(0)), s.now(0))
    assert (o["code"] == 0).all() and (o["ingress_rule"] >= 0).all()
    mix["classes"][0]["kind"] = "external_in"
    s = Stream(mix, plain, 8)
    o = ref.step(ref.lanes(s.columns(0)), s.now(0))
    assert (o["code"] != 0).all()
