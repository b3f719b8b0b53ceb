"""The plain reference against the port's engine on the CPU: every output
field of every lane, and the miss count, step after step through slot
collisions, replies, retransmissions to denied connections and ageing, on
both worlds' shapes and on mixes that differ only in their data; and
through ClusterIP Services (with and without ClientIP affinity, without
endpoints, pins colliding) whose replies come from the endpoint the
engine chose."""

import copy

import numpy as np
import pytest

import torch

from conftest import SMALL_MIX, SVC_MIX, service_config, small_config
from flowbench.harness import _program_columns, build_engine
from flowbench.reference.datapath import FIELDS, Replay
from flowbench.reference.hashing import flow_hash
from flowbench.stream import Stream
from flowbench.world import build_world, plain_world


def _aged(cfg, timeout):
    cfg["engine"]["ct_timeout_s"] = timeout
    return cfg


def _flood():
    """Few outside sources opening connections to local Pods that never
    answer, beside the admitted traffic."""
    mix = copy.deepcopy(SMALL_MIX)
    mix["classes"] = [
        {"name": "flood", "kind": "external_in", "share": 0.7,
         "replies": False, "sources": 3},
        {"name": "admitted_in", "kind": "policy_in", "share": 0.3,
         "replies": True}]
    return mix


@pytest.mark.parametrize("cfg,mix,seed,now_step", [
    (small_config(), SMALL_MIX, 1, 1),
    (small_config(), SMALL_MIX, 2**31 + 5, 1),
    (small_config("one_ns"), SMALL_MIX, 7, 1),
    (small_config("one_ns"), SMALL_MIX, -3, 1),
    (small_config(), _flood(), 9, 1),
    # Established hits refresh their partners every step; entries not
    # used for more than the timeout age out between steps.
    (_aged(small_config(), 6), SMALL_MIX, 4, 4),
    (_aged(small_config("one_ns"), 6), SMALL_MIX, 4, 7),
    (service_config(), SVC_MIX, 1, 1),
    (service_config(), SVC_MIX, 2**31 + 6, 1),
    (service_config("small_ns"), SVC_MIX, 12, 1),
    (_aged(service_config(), 6), SVC_MIX, 4, 4),
])
def test_reference_equals_engine(cfg, mix, seed, now_step):
    w = build_world(cfg)
    plain = plain_world(w)
    st = Stream(dict(mix, now_step=now_step), plain, seed)
    eng = build_engine(w, "cpu")
    ref = Replay(plain, "cpu")
    seen = dict.fromkeys(("est", "committed", "reply", "hits", "allowed",
                          "denied"), 0)
    svc = dict.fromkeys(("sent", "turned", "hit", "pinned"), 0)
    for t in range(14):
        cols = st.columns(t)
        if st.services:
            svc.update(_service_lanes(st, t, cols, ref, svc))
        r = eng.step(st.batch(t), st.now(t))
        o = ref.step(ref.lanes(cols), st.now(t))
        got = _program_columns(r, ref.cls.index)
        assert r.n_miss == o["n_miss"], t
        for f in FIELDS:
            assert np.array_equal(got[f], o[f]), (t, f)
        st.observe(t, r)
        if st.services:
            turned = cols["src_ip"] != st.templates[t % st.period]["src_ip"]
            svc["hit"] += int(o["reply"][turned].sum())
        seen["est"] += int(o["est"].sum())
        seen["committed"] += int(o["committed"].sum())
        seen["reply"] += int(o["reply"].sum())
        seen["hits"] += len(o["code"]) - o["n_miss"]
        seen["allowed"] += int((o["code"] == 0).sum())
        seen["denied"] += int((o["code"] != 0).sum())
    # The steps went through commits, denials, and, where entries outlive
    # a step, conntrack hits of both directions; none where they do not.
    assert seen["committed"] and seen["allowed"] and seen["denied"]
    if now_step <= cfg["engine"]["ct_timeout_s"]:
        assert seen["est"] and seen["hits"] and seen["reply"]
    else:
        assert not seen["hits"]
    if st.services:
        # Most Service packets drawn as replies came from the endpoint,
        # and most of those hit the reply entry its first packet left;
        # some first packets took their client's pin, not the hash's pick.
        assert svc["turned"] > 0.6 * svc["sent"], svc
        assert svc["hit"] > 0.6 * svc["turned"], svc
        assert svc["pinned"], svc


def _service_lanes(st, t, cols, ref, svc) -> dict:
    """Service replies drawn for step t and those turned round (from the
    endpoint), and Service first packets whose endpoint is not the flow
    hash's pick (the reference's LB with its pins and with none)."""
    T = st.templates[t % st.period]
    sent = sum(sl.stop - sl.start for age, sl in T["svc_ages"] if t >= age)
    turned = int((cols["src_ip"] != T["src_ip"]).sum())
    c = ref.lanes({k: v[:st.new] for k, v in cols.items()})
    h = flow_hash(c["src_ip"], c["dst_ip"], c["proto"], c["src_port"],
                  c["dst_port"])
    now = st.now(t)
    args = (c["src_ip"], c["dst_ip"], c["proto"], c["dst_port"], h)
    pins = ref.lb.resolve(*args, ref.aff, ref.aff_slots, now)
    none = ref.lb.resolve(*args, [torch.zeros_like(a) for a in ref.aff],
                          ref.aff_slots, now)
    pinned = int((pins["dnat_ip"] != none["dnat_ip"]).sum())
    return {"sent": svc["sent"] + sent, "turned": svc["turned"] + turned,
            "pinned": svc["pinned"] + pinned}
