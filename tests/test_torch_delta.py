"""Pending membership deltas in the PyTorch port against the JAX package, on
the CPU: the delta primitives, the overlay route, and classify_batch with
delta slots pending (unfused, fused through B1's plain version, and pruned
through B2's), on the same DeviceRuleSet.  Every value is an int32 or u32
word, so the tolerance is exact equality.  The JAX side runs its Pallas
consumers in interpret mode, as its own tests do on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antrea_tpu.compiler.compile import compile_policy_set as j_compile
from antrea_tpu.ops import match as jm
from antrea_tpu.simulator import gen_cluster as j_gen_cluster
from antrea_tpu.simulator import gen_traffic as j_gen_traffic
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.ops import consumer as tc
from antrea_tpu_torch.ops import match as tm

from test_torch_engine import engine_scenario, engine_world

_KEYS = ("code", "egress_code", "egress_rule", "ingress_code",
         "ingress_rule")
_PRUNE_KEYS = ("prune_skip", "prune_fb", "prune_cand")
_MASKS = ("at_in", "peer_in", "at_out", "peer_out")


def _t(a) -> torch.Tensor:
    """numpy u32/i32 -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32))


def _flip(ips) -> np.ndarray:
    return iputil.flip_u32(np.asarray(ips, np.uint32)).astype(np.int32)


def _delta_table(rng, ips_f, w_in, w_out, slots, n, dens=0.08):
    """A numpy DeltaTable of `slots` capacity with n active slots: /32
    ranges on lane addresses, one /28-wide range, signs of both kinds and
    random rule masks.  Slot 1 clears on lane address ips_f[0] a mask that
    overlaps slot 0's set on the same address (set, then clear, of the same
    lane and word)."""
    dt = {k: np.asarray(v) for k, v in
          jm.empty_delta(slots, w_in, w_out, xp=np)._asdict().items()}
    dt = {k: v.copy() for k, v in dt.items()}
    picks = rng.choice(ips_f, size=n, replace=True)
    picks[0] = picks[1] = ips_f[0]
    for i in range(n):
        lo = hi = int(picks[i])
        if i == 2:
            hi = lo + 15  # a /28-wide slot covering several lanes
        dt["lo_f"][i], dt["hi_f"][i] = lo, hi
        dt["sign"][i] = 1 if i % 3 != 1 else -1
        dt["iso"][i] = int(rng.integers(0, 4))
        for k in _MASKS:
            w = w_in if k.endswith("_in") else w_out
            bits = rng.random((w, 32)) < dens
            dt[k][i] = (bits.astype(np.uint64)
                        << np.arange(32, dtype=np.uint64)).sum(
                            axis=1).astype(np.uint32)
    dt["sign"][1] = -1
    for k in _MASKS:  # slot 1 clears part of what slot 0 set
        dt[k][1] = dt[k][0] & np.uint32(0x0F0F0F0F)
    dt["n"] = np.int32(n)
    return jm.DeltaTable(**dt)


def _jdelta(dt):
    return jax.tree_util.tree_map(jnp.asarray, dt)


def _tdelta(dt):
    return tm.from_numpy(tm.DeltaTable, dt, torch.device("cpu"))


@pytest.fixture(scope="module")
def world():
    """The pruned world of tests/test_match_fused.py (S_in = 2, so K = 1
    falls back) and a batch whose lanes repeat a few addresses."""
    jc = j_gen_cluster(2500, seed=12)
    cps = j_compile(jc.ps)
    tr = j_gen_traffic(jc.pod_ips, 192, n_flows=96, seed=9)
    src = _flip(tr.src_ip)
    dst = _flip(tr.dst_ip)
    proto = np.asarray(tr.proto, np.int32)
    dport = np.asarray(tr.dst_port, np.int32)
    return jc, cps, (src, dst, proto, dport)


@pytest.mark.parametrize("what", ["rows", "iso", "agg"])
def test_delta_primitives_equal_reference(what):
    rng = np.random.default_rng({"rows": 1, "iso": 2, "agg": 3}[what])
    b, w = 96, 64
    ips = _flip(rng.integers(0x0A000000, 0x0A000040, b))
    dt = _delta_table(rng, ips, w, w, slots=16, n=11)
    jd, td = _jdelta(dt), _tdelta(dt)
    n = int(dt.n)
    ip_j, ip_t = jnp.asarray(ips), _t(ips)
    for i in range(n):
        np.testing.assert_array_equal(
            tm._delta_lane_match(ip_t, td, i).numpy(),
            np.asarray(jm._delta_lane_match(ip_j, jd, i, None)))
    if what == "rows":
        rows = (rng.random((b, w, 32)) < 0.3)
        rows = (rows.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
            axis=2).astype(np.uint32)
        for k in _MASKS:
            want = np.asarray(jm._patch_rows(jnp.asarray(rows), ip_j, jd,
                                             getattr(jd, k)))
            got = tm._patch_rows(_t(rows), ip_t, td, getattr(td, k), n)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    elif what == "iso":
        bit = rng.integers(0, 2, b).astype(np.int32)
        for which in (0, 1):
            want = np.asarray(jm._patch_iso(jnp.asarray(bit), ip_j, jd,
                                            which))
            got = tm._patch_iso(_t(bit), ip_t, td, which, n)
            np.testing.assert_array_equal(got.numpy(), want)
            assert (got.numpy() != bit).any()
    else:
        s = w // jm.AGG_BLOCK
        rows = rng.integers(0, 2**32, (b, s), dtype=np.uint64).astype(
            np.uint32) & np.uint32(0x00FF00FF)
        for k in _MASKS:
            np.testing.assert_array_equal(
                tm._agg_mask(_t(getattr(dt, k))).numpy().view(np.uint32),
                np.stack([np.asarray(jm._agg_mask(jnp.asarray(r)))
                          for r in getattr(dt, k)]))
            want = np.asarray(jm._patch_agg(jnp.asarray(rows), ip_j, jd,
                                            getattr(jd, k)))
            got = tm._patch_agg(_t(rows), ip_t, td, getattr(td, k), n)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_set_then_clear_leaves_the_later_slot_winning():
    """A clear after a set of the same lane and bits leaves them clear; a
    set after a clear leaves them set (slots apply in order)."""
    ips = _flip([0x0A000001, 0x0A000002])
    dt = {k: np.asarray(v).copy() for k, v in
          jm.empty_delta(4, 1, 1, xp=np)._asdict().items()}
    dt["lo_f"][:3] = dt["hi_f"][:3] = ips[0]
    dt["sign"][:3] = (1, -1, 1)
    for k in _MASKS:
        dt[k][:3, 0] = (0xFF, 0x0F, 0x03)
    dt["n"] = np.int32(3)
    td = _tdelta(jm.DeltaTable(**dt))
    rows = _t(np.zeros((2, 1), np.uint32))
    got = tm._patch_rows(rows, _t(ips), td, td.at_in, 2).numpy()
    assert got.tolist() == [[0xF0], [0]]
    got = tm._patch_rows(rows, _t(ips), td, td.at_in, 3).numpy()
    assert got.tolist() == [[0xF3], [0]]


def _rule_sets(cps, k, dt):
    """The JAX and the port's DeviceRuleSet of one compile, with the delta
    table dt in place, and their metas."""
    slots = dt.sign.shape[0]
    jhost, jmeta = jm.to_host(cps, delta_slots=slots, prune_budget=k)
    jhost = jhost._replace(ip_delta=dt)
    jdrs = jax.tree_util.tree_map(jnp.asarray, jhost)
    tdrs = tm.ruleset_from_numpy(jhost, "cpu")
    tmeta = tm.StaticMeta(jmeta.in_phases, jmeta.out_phases, jmeta.w_in,
                          jmeta.w_out, jmeta.svcref, k, slots)
    return jdrs, jmeta._replace(fused_interpret=True), tdrs, tmeta


@pytest.mark.parametrize("fused,k", [(False, 0), (True, 0), (False, 1),
                                     (True, 1)],
                         ids=["unfused", "fused-b1", "pruned", "pruned-b2"])
def test_classify_with_pending_deltas_equals_reference(world, fused, k):
    jc, cps, (src, dst, proto, dport) = world
    rng = np.random.default_rng(17 + k + 2 * fused)
    jh, jmeta = jm.to_host(cps, prune_budget=k)
    # Lane addresses of both sides, plus slot masks that are real groups'
    # rule bitmaps (what the engine appends) mixed with random ones.
    dt = _delta_table(rng, np.concatenate([src[:24], dst[:24]]), jmeta.w_in,
                      jmeta.w_out, slots=32, n=12, dens=0.02)
    gids = (cps.ingress.peer_gid, cps.ingress.at_gid, cps.egress.peer_gid,
            cps.egress.at_gid)
    for i in (3, 4):
        for kname, g in zip(("peer_in", "at_in", "peer_out", "at_out"), gids):
            w = jmeta.w_in if kname.endswith("_in") else jmeta.w_out
            dt = dt._replace(**{kname: getattr(dt, kname).copy()})
            getattr(dt, kname)[i] = jm._inc_mask(
                np.nonzero(g == g[i * 7 % len(g)])[0], w)
    jdrs, jm_, tdrs, tm_ = _rule_sets(cps, k, dt)
    n = int(dt.n)
    want = jax.device_get(jm.classify_batch(
        jdrs, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(proto),
        jnp.asarray(dport), meta=jm_, fused=fused))
    before = tc.launches
    got = tm.classify_batch(tdrs, _t(src), _t(dst), _t(proto), _t(dport),
                            meta=tm_, fused=fused, delta_n=n)
    assert tc.launches == before
    keys = _KEYS + (_PRUNE_KEYS if k else ())
    for key in keys:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    # The deltas changed verdicts: without them the port differs.
    plain = tm.classify_batch(tdrs, _t(src), _t(dst), _t(proto), _t(dport),
                              meta=tm_, fused=fused)
    assert any((plain[key] != got[key]).any() for key in keys)
    if k:
        assert got["prune_fb"].any() and not got["prune_fb"].all()


def test_overlay_rows_follow_distinct_addresses(world):
    """The overlay holds one row per (interval row, covering slots), not
    one per lane: 192 lanes over a few addresses need few rows."""
    _, cps, (src, dst, proto, dport) = world
    rng = np.random.default_rng(4)
    jh, jmeta = jm.to_host(cps)
    dt = _delta_table(rng, src[:8], jmeta.w_in, jmeta.w_out, slots=16, n=6)
    _, _, tdrs, tm_ = _rule_sets(cps, 0, dt)
    src_t = _t(np.repeat(src[:8], 24))
    dst_t = _t(np.repeat(dst[:8], 24))
    key = _t(np.repeat((proto[:8] << 16) | dport[:8], 24))
    iv = tm.interval_rows(tdrs, src_t, dst_t, key)
    ov = tm.delta_overlay(tdrs, iv, src_t, dst_t, int(dt.n))
    assert ov is not None and ov.lanes.numel() >= 24
    for col in (0, 1, 3, 4):
        assert ov.tabs[col].shape[0] <= 8
        assert int(ov.iv[:, col].max()) < ov.tabs[col].shape[0]
    assert ov.tabs[2] is tdrs.ingress.svc.inc
    # No lane covered: no overlay.
    far = _t(_flip(np.full(4, 0xC0A80001)))
    iv4 = tm.interval_rows(tdrs, far, far, _t(np.zeros(4, np.int32)))
    assert tm.delta_overlay(tdrs, iv4, far, far, int(dt.n)) is None


def test_onepass_engine_with_deltas_equals_reference():
    """The engine in the one-pass mode (fused=True, prune_budget=2) held to
    the JAX engine through tests/test_torch_engine.py's scenario: every
    lane a pending delta covers is forced to the fallback (B3's fb_force),
    re-walked on its overlay, with its isolation bits and prune counters
    patched."""
    engine_scenario(engine_world(), "onepass")
