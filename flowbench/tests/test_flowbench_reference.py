"""The plain reference against the port's engine on the CPU: every output
field of every lane, and the miss count, step after step through slot
collisions, replies, retransmissions to denied connections and ageing, on
both worlds' shapes and on mixes that differ only in their data."""

import copy

import numpy as np
import pytest

from conftest import SMALL_MIX, small_config
from flowbench.harness import _program_columns, build_engine
from flowbench.reference.datapath import FIELDS, Replay
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
])
def test_reference_equals_engine(cfg, mix, seed, now_step):
    w = build_world(cfg)
    plain = plain_world(w)
    st = Stream(dict(mix, now_step=now_step), plain, seed)
    eng = build_engine(w, "cpu")
    ref = Replay(plain, "cpu")
    seen = dict.fromkeys(("est", "committed", "reply", "hits", "allowed",
                          "denied"), 0)
    for t in range(14):
        r = eng.step(st.batch(t), st.now(t))
        o = ref.step(ref.lanes(st.columns(t)), st.now(t))
        got = _program_columns(r, ref.cls.index)
        assert r.n_miss == o["n_miss"], t
        for f in FIELDS:
            assert np.array_equal(got[f], o[f]), (t, f)
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
