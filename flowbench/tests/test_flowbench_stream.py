"""The traffic generator: the same seed gives the same batches and another
seed others; every step opens connections never seen before; a reply
follows its connection's first packet and comes only for classes that
reply; a lane enters at its source's port; policy_in connections are the
ones the policy admits; service connections go to the world's frontends,
and their replies come from the endpoint observed for their first packet;
a mix without them gives the same columns as before Services came in."""

import copy
import hashlib
from pathlib import Path

import numpy as np
import pytest

from conftest import SMALL_MIX, SVC_MIX, service_config, small_config
from flowbench.reference.datapath import Replay
from flowbench.stream import OFPORT_GATEWAY, OFPORT_TUNNEL, Stream
from flowbench.world import build_world, load_config, plain_world

FLOWBENCH = Path(__file__).resolve().parents[1]

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


# sha256 over steps 0-40 of conn_churn's columns (each column's name,
# dtype and bytes, names sorted), as the generator gave them before the
# service kind and the closed loop came in.
_CHURN_DIGEST = {
    ("small_ns", 7): "23513d08c6cfcfdd6fc8f9527d96b1fd"
                     "dfaf30d26ff205b45e1619d2e76123d1",
    ("small_ns", 2**31 + 77): "d3e2357e23c1e7e219ce941cc7617143"
                              "f42e2808d355c46d7a889ab21939f459",
    ("one_ns", 7): "9458b7917f06c70ffd425b93f541ec93"
                   "d1a655572911d88d81bd6172204218e2",
    ("one_ns", 2**31 + 77): "7dfcf5f1aa9bbc642f7758de1af46fe6"
                            "f66811e79cc357d926d61c5e7af33217",
    ("one_ns_10k", 7): "59cff815a6f92948b379a1d0adcb47ef"
                       "36f727783cf3b13704d8c003a425ed20",
    ("one_ns_10k", 2**31 + 77): "55aafa457612aaac8e1d12f3901694a3"
                                "e1b4a99b1ae06ba20255f9f2e895945b",
}


@pytest.mark.parametrize("world,seed", sorted(_CHURN_DIGEST))
def test_conn_churn_columns_unchanged(world, seed):
    """A mix without a service class reads the same lanes as before, and
    columns(t) hands out the templates' own arrays, uncopied."""
    cfg = (load_config(FLOWBENCH / "configs" / "one_ns_10k.json")
           if world == "one_ns_10k" else small_config(world))
    mix = load_config(FLOWBENCH / "traffic" / "conn_churn.json")
    s = Stream(mix, plain_world(build_world(cfg)), seed)
    h = hashlib.sha256()
    for t in range(41):
        c = s.columns(t)
        s.observe(t, None)
        for k in sorted(c):
            h.update(k.encode())
            h.update(str(c[k].dtype).encode())
            h.update(c[k].tobytes())
    assert h.hexdigest() == _CHURN_DIGEST[(world, seed)]
    assert c["src_ip"] is s.templates[40 % s.period]["src_ip"]


@pytest.fixture(params=["small_ns", "one_ns"])
def svc_plain(request):
    return plain_world(build_world(service_config(request.param)))


def _svc_only(**kw):
    mix = copy.deepcopy(SMALL_MIX)
    mix["classes"] = [dict({"name": "to_service", "kind": "service",
                            "share": 1, "replies": True}, **kw)]
    return mix


def _u32(ip):
    return int.from_bytes(bytes(map(int, ip.split("."))), "big")


def test_service_connections_go_to_frontends(svc_plain):
    s = Stream(_svc_only(), svc_plain, 4)
    cols = s.columns(0)
    front = {(_u32(v["ip"]), v["proto"], v["port"])
             for v in svc_plain["services"]}
    local = {_u32(ip): p for ip, p in svc_plain["topology"]["local_pods"]}
    for src, dst, proto, dport, inp in zip(
            *(cols[k].tolist() for k in ("src_ip", "dst_ip", "proto",
                                         "dst_port", "in_port"))):
        assert (dst, proto, dport) in front
        assert local[src] == inp


def test_service_popularity_skews_frontends(svc_plain):
    def top_share(**kw):
        s = Stream(_svc_only(**kw), svc_plain, 6)
        d = np.concatenate([T["dst_ip"][:s.new] for T in s.templates])
        return np.unique(d, return_counts=True)[1].max() / len(d)
    n = len(svc_plain["services"])
    assert top_share() < 3 / n
    # Zipf rank-1.2 over 40 Services: the first rank takes about 0.27.
    assert top_share(popularity=1.2) > 0.2


def test_service_needs_services():
    plain = plain_world(build_world(small_config("one_ns")))
    with pytest.raises(ValueError, match="no Services"):
        Stream(_svc_only(), plain, 1)


def test_service_replies_come_from_the_observed_endpoint(svc_plain):
    """Every first packet observed allowed and sent to one endpoint, 10.0.0.2
    (a local Pod, or another node's) port 9999, but those of step 2,
    observed rejected: the replies drawn come from that endpoint, to the
    client, entering at the endpoint's port, except those of step 2's
    connections and of connections opened before step 0, which are the
    client's forward packet again."""
    s = Stream(_svc_only(), svc_plain, 9)
    ep = _u32("10.0.0.2")
    local = {_u32(ip): p for ip, p in svc_plain["topology"]["local_pods"]}
    pods = set(np.asarray(svc_plain["pod_ips"]).tolist())
    ep_port = local.get(ep, OFPORT_TUNNEL if ep in pods else OFPORT_GATEWAY)
    first = {}
    for t in range(2 * s.period):
        cols = s.columns(t)
        T = s.templates[t % s.period]
        for i in range(s.new):
            first[(t, i)] = tuple(cols[k][i] for k in
                                  ("src_ip", "dst_ip", "src_port",
                                   "dst_port", "in_port"))
        n = s.new
        s.observe(t, {"code": np.full(s.batch_size, 2 if t == 2 else 0),
                      "dnat_ip": np.full(s.batch_size, ep, np.uint32),
                      "dnat_port": np.full(s.batch_size, 9999)})
        for age, sl in T["svc_ages"]:
            lanes = np.arange(T["svc_from"], s.batch_size)[sl]
            assert age >= 1 and (lanes >= n).all()
            for j in lanes.tolist():
                got = tuple(cols[k][j] for k in ("src_ip", "dst_ip",
                                                 "src_port", "dst_port",
                                                 "in_port"))
                if t - age < 0 or t - age == 2:
                    assert got[1] != ep and got[2] != 9999
                    if t - age == 2:
                        assert got in set(first[(2, i)] for i in range(n))
                    continue
                client = [f for (u, _), f in first.items() if u == t - age
                          and f[0] == got[1] and f[2] == got[3]]
                assert client, (t, j)
                assert got[0] == ep and got[2] == 9999
                assert got[4] == ep_port


def test_service_columns_need_the_steps_observed(svc_plain):
    s = Stream(_svc_only(), svc_plain, 9)
    s.columns(0)
    with pytest.raises(ValueError, match="observe"):
        s.columns(1)
    s.observe(0, {"code": np.zeros(s.batch_size, int),
                  "dnat_ip": np.zeros(s.batch_size, np.uint32),
                  "dnat_port": np.zeros(s.batch_size, int)})
    s.columns(1)
    with pytest.raises(ValueError, match="observe"):
        s.observe(2, {})


def test_mixes_differ_only_in_service_lanes(svc_plain):
    """Observed and unobserved, a Service mix's lanes differ only where a
    reply was turned round to its endpoint."""
    s = Stream(SVC_MIX, svc_plain, 5)
    ref = Replay(svc_plain, "cpu")
    for t in range(s.life + 3):
        cols = s.columns(t)
        T = s.templates[t % s.period]
        turned = cols["src_ip"] != T["src_ip"]
        assert not turned[:T["svc_from"]].any()
        s.observe(t, ref.step(ref.lanes(cols), s.now(t)))
        if t > s.life:
            assert turned.any()
