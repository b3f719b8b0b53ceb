"""The PyTorch port's aggregate-pruned classify against the JAX package, on
the CPU: the aggregate tables, the plain B2 consumer against the Pallas
kernel in interpret mode, and classify_batch(prune_budget=K).  Every value
is an int32 or u32 word: the tolerance is exact equality."""

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
from antrea_tpu_torch.compiler.compile import compile_policy_set as t_compile
from antrea_tpu_torch.ops import consumer as tc
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.ops import pruned_consumer as tpc
from antrea_tpu_torch.simulator import gen_cluster as t_gen_cluster
import torch_cpu  # noqa: F401  (one torch thread a worker)

_KEYS = ("code", "egress_code", "egress_rule", "ingress_code",
         "ingress_rule", "prune_skip", "prune_fb", "prune_cand")


def _t(a) -> torch.Tensor:
    """numpy u32/i32 -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32))


def _leaves(tree, prefix=""):
    if tree is None:
        return [(prefix, None)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _leaves(getattr(tree, f), f"{prefix}.{f}")
        return out
    return [(prefix, tree)]


@pytest.fixture(scope="module")
def world():
    """The pruned world of tests/test_match_fused.py (S_in = 2, so K = 1
    falls back), built by each package from its own generator."""
    jc = j_gen_cluster(2500, seed=12)
    return jc, j_compile(jc.ps), t_compile(t_gen_cluster(2500, seed=12).ps)


def test_constants_equal_reference():
    for name in ("AGG_BLOCK", "PRUNE_LADDER", "PRUNE_HIST_BOUNDS", "_FB_MIN"):
        assert getattr(tm, name) == getattr(jm, name), name


def test_to_host_pruned_equals_reference(world):
    _, jcps, tcps = world
    jdrs, jmeta = jm.to_host(jcps, prune_budget=2)
    tdrs, tmeta = tm.to_host(tcps, prune_budget=2)
    jl, tl = _leaves(jdrs), _leaves(tdrs)
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (k, a), (_, b) in zip(jl, tl):
        if a is None:
            assert b is None, k
            continue
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for f in tm.StaticMeta._fields:
        assert getattr(tmeta, f) == getattr(jmeta, f), f
    assert tdrs.ingress.at.agg.shape[1] >= 2
    # The aggregate level reaches the device as int32 with the same bits.
    drs, meta = tm.to_device(tcps, "cpu", prune_budget=2)
    assert meta.prune_budget == 2
    agg = drs.egress.peer.agg
    assert agg.dtype == torch.int32
    np.testing.assert_array_equal(agg.numpy().view(np.uint32),
                                  jdrs.egress.peer.agg)


@pytest.mark.parametrize("w", [45, 64])
def test_build_agg_equals_reference(w):
    rng = np.random.default_rng(w)
    inc = rng.integers(0, 2**32, (9, w), dtype=np.uint64).astype(np.uint32)
    inc[rng.random((9, w)) < 0.6] = 0  # zero words: clear aggregate bits
    inc[3] = 0
    got = tm.build_agg(inc)
    np.testing.assert_array_equal(got, jm.build_agg(inc))
    assert got.dtype == np.uint32 and got.shape == (9, -(-w // 32))


def _cand_case(rng, b, ke, s, w0, dens):
    """Seeded B2 inputs of one direction: ke candidate superblocks per lane
    among s (ascending, fill candidates at S-1 with all-zero words), their
    words at lane i's bit density dens[i % len(dens)], and the base
    matrix."""
    ids = np.full((b, ke), s, np.int64)
    for i in range(b):
        n = i % (ke + 1)  # 0 .. ke real candidates
        ids[i, :n] = np.sort(rng.choice(s, size=n, replace=False))
    cand = torch.from_numpy(np.minimum(ids, s - 1))
    valid = ids < s
    mats = []
    for _ in range(3):
        d = np.resize(np.asarray(dens), b)[:, None, None, None]
        bits = rng.random((b, ke, 32, 32)) < d
        words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)
                 ).sum(axis=3).astype(np.uint32)
        mats.append(words)
    mats[0][~valid] = 0
    base = tpc.candidate_base(cand, w0).numpy()
    return [m.reshape(b, ke * 32) for m in mats] + [base]


# (id, ke_in, s_in, ke_out, s_out, in_phases, out_phases, (w0_in, w0_out))
_B2_CASES = [
    ("bounds-inside-blocks", 3, 5, 2, 4, (1000, 1500, 600), (700, 900, 300),
     (0, 0)),
    ("bounds-on-block-edges", 2, 4, 2, 3, (1024, 1024, 2048), (2048, 1024, 0),
     (0, 0)),
    ("empty-phase", 2, 4, 1, 2, (0, 2000, 2000), (900, 0, 100), (0, 0)),
    ("word-offsets", 2, 3, 2, 3, (5000, 500, 100), (3400, 900, 50), (96, 64)),
]


@pytest.mark.parametrize("case", _B2_CASES, ids=lambda c: c[0])
def test_plain_pruned_consumer_equals_pallas(case):
    _, ke_i, s_i, ke_o, s_o, in_ph, out_ph, (w0_i, w0_o) = case
    b = 37  # ragged for the port; the Pallas kernel takes 128 lanes
    rng = np.random.default_rng(ke_i * 7 + s_i)
    # Three-way ANDs of density 0.3**3 down to 0.1**3 per bit: first hits
    # from the first word to some words deep.
    m_in = _cand_case(rng, b, ke_i, s_i, w0_i, (0.3, 0.1, 0.2))
    m_out = _cand_case(rng, b, ke_o, s_o, w0_o, (0.2, 0.3, 0.1))

    def pad(x):
        return np.pad(x, ((0, 128 - b), (0, 0)))

    call = jm._pruned_consumer_call(128, ke_i * 32, ke_o * 32, in_ph, out_ph,
                                    True)
    want = np.asarray(call(*(jnp.asarray(pad(x)) for x in m_in + m_out)))[:b]
    before = tpc.launches
    got = tpc.pruned_plain([_t(x) for x in m_in], [_t(x) for x in m_out],
                           in_ph, out_ph)
    assert tpc.launches == before  # the plain version never launches
    assert got.shape == (b, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, :6] < jm.BIG).any() and (want[:, :6] == jm.BIG).any()


def test_pruned_consumer_wrapper_checks_its_inputs():
    t = torch.zeros((4, 64), dtype=torch.int32)
    tabs = (t,) * 6
    g = torch.zeros((5, 2), dtype=torch.int32)
    iv = torch.zeros((5, 8), dtype=torch.int32)
    ph = (10, 10, 10)
    got = tpc.pruned_hits(g, g, iv, tabs, 2, 1, True, ph, ph)
    assert got.shape == (5, 8) and got.dtype == torch.int32
    assert got.device == iv.device and got.is_contiguous()
    assert (got[:, :6] == tm.BIG).all() and not got[:, 6:].any()
    with pytest.raises(TypeError):  # int64 aggregate rows
        tpc.pruned_hits(g.long(), g, iv, tabs, 2, 2, False, ph, ph)
    with pytest.raises(TypeError):  # an int64 table
        tpc.pruned_hits(g, g, iv, (t.long(),) + tabs[1:], 2, 2, False, ph, ph)
    with pytest.raises(ValueError):  # g not (B, width / 32)
        tpc.pruned_hits(g[:, :1].contiguous(), g, iv, tabs, 1, 2, False, ph,
                        ph)
    with pytest.raises(ValueError):  # g of another batch
        tpc.pruned_hits(g[:4].contiguous(), g, iv, tabs, 2, 2, False, ph, ph)
    with pytest.raises(ValueError):  # g not contiguous
        tpc.pruned_hits(torch.zeros((2, 5), dtype=torch.int32).t(), g, iv,
                        tabs, 2, 2, False, ph, ph)
    with pytest.raises(ValueError):  # iv not (B, 8)
        tpc.pruned_hits(g, g, iv[:, :7].contiguous(), tabs, 2, 2, False, ph,
                        ph)
    with pytest.raises(ValueError):  # egress widths disagree
        tpc.pruned_hits(g, g, iv, tabs[:5] + (t[:, :32].contiguous(),), 2, 2,
                        False, ph, ph)
    with pytest.raises(ValueError):  # ke outside [1, S]
        tpc.pruned_hits(g, g, iv, tabs, 3, 2, False, ph, ph)
    with pytest.raises(ValueError):
        tpc.pruned_hits(g, g, iv, tabs, 2, 0, False, ph, ph)


def _jax_cand_mats(tabs, g, iv3, iv_ref, ke, w0):
    """The JAX package's cand_mats (antrea_tpu/ops/match.py:1656-1700, no
    delta slots) for one direction, in jnp: top_k of the scores, the
    candidate-block gathers, the zeroed fill words, the base matrix."""
    B, S = g.shape
    g = jnp.asarray(g)
    score = jnp.where(g != jnp.uint32(0),
                      jax.lax.broadcasted_iota(jnp.int32, (B, S), 1), S)
    neg, _ = jax.lax.top_k(-score, ke)
    cand = -neg
    valid = cand < S
    candc = jnp.minimum(cand, S - 1)

    def cwords(tab, r):
        inc2 = jnp.asarray(tab).reshape(-1, jm.AGG_BLOCK)
        return inc2[jnp.asarray(r)[:, None] * S + candc]

    ca, cp, cs = (cwords(t, r) for t, r in zip(tabs, iv3))
    if iv_ref is not None:
        cs = cs | cwords(tabs[2], iv_ref)
    ca = jnp.where(valid[:, :, None], ca, jnp.uint32(0))
    j = jnp.arange(jm.AGG_BLOCK, dtype=jnp.int32)[None, None, :]
    base = (w0 + candc[:, :, None] * jm.AGG_BLOCK + j) * 32
    return [x.reshape(B, ke * jm.AGG_BLOCK) for x in (ca, cp, cs, base)]


def _agg_rows(rng, b, s, counts):
    """(b, s) u32 aggregate AND rows: lane i has counts[i] nonzero words at
    seeded positions."""
    g = np.zeros((b, s), np.uint32)
    for i, n in enumerate(counts):
        pos = rng.choice(s, size=n, replace=False)
        g[i, pos] = rng.integers(1, 2**32, n, dtype=np.uint64).astype(
            np.uint32)
    return g


# (id, ke_in, ke_out, svcref, (w0_in, w0_out))
_B2_TABLE_CASES = [
    ("plain", 2, 3, False, (0, 0)),
    ("svcref", 2, 3, True, (0, 0)),
    ("one-candidate", 1, 1, True, (0, 0)),
    ("word-offsets", 3, 2, True, (64, 96)),
]


@pytest.mark.parametrize("case", _B2_TABLE_CASES, ids=lambda c: c[0])
def test_pruned_hits_from_tables_equals_pallas(case):
    """B2's entry (aggregate AND rows, interval rows, tables) against the
    JAX _pruned_consumer_call in interpret mode fed by the JAX cand_mats
    logic on the same g, iv and tables.  Lanes hold 0 candidates, fewer than
    ke, exactly ke and more than ke (whose ke-lowest scan is compared)."""
    _, ke_in, ke_out, svcref, (w0_in, w0_out) = case
    b, s_in, s_out = 37, 5, 4
    rng = np.random.default_rng(ke_in * 11 + ke_out + svcref)
    tabs = [_bit_rows(rng, n, 32 * s, [0.4] * n)
            for n, s in ((6, s_in), (9, s_in), (5, s_in), (7, s_out),
                         (8, s_out), (6, s_out))]
    g_in = _agg_rows(rng, b, s_in, [i % (s_in + 1) for i in range(b)])
    g_out = _agg_rows(rng, b, s_out, [(i + 2) % (s_out + 1) for i in range(b)])
    iv = np.zeros((b, 8), np.int32)
    for k in range(7):
        n = tabs[min(k, 5)].shape[0]
        iv[:, k] = rng.integers(0, n, b)
        iv[k, k] = n - 1
    in_ph = (1000 + w0_in * 32, 3000, 600)
    out_ph = (w0_out * 32 + 40, 500, 300)

    m_in = _jax_cand_mats(tabs[:3], g_in, [iv[:, k] for k in range(3)],
                          None, ke_in, w0_in)
    m_out = _jax_cand_mats(tabs[3:], g_out, [iv[:, k] for k in range(3, 6)],
                           iv[:, 6] if svcref else None, ke_out, w0_out)
    call = jm._pruned_consumer_call(128, ke_in * 32, ke_out * 32, in_ph,
                                    out_ph, True)
    pad = [jnp.pad(x, ((0, 128 - b), (0, 0))) for x in m_in + m_out]
    want = np.asarray(call(*pad))[:b]

    before = tpc.launches
    got = tpc.pruned_hits(_t(g_in), _t(g_out), _t(iv),
                          tuple(_t(t) for t in tabs), ke_in, ke_out, svcref,
                          in_ph, out_ph, w0_in, w0_out)
    assert tpc.launches == before  # CPU tensors never launch the kernel
    assert got.shape == (b, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, :6] < jm.BIG).any() and (want[:, :6] == jm.BIG).any()


def _bit_rows(rng, n, w, dens):
    """(n, w) u32 words, row i's bits set with probability dens[i]."""
    bits = rng.random((n, w, 32)) < np.asarray(dens)[:, None, None]
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=2).astype(np.uint32)


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
@pytest.mark.parametrize("k", [1, 2])
def test_classify_pruned_equals_reference(world, fused, k):
    jc, jcps, tcps = world
    tr = j_gen_traffic(jc.pod_ips, 256, n_flows=256, seed=6)
    args = (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip),
            tr.proto.astype(np.int32), tr.dst_port.astype(np.int32))
    jdrs, jmeta = jm.to_device(jcps, prune_budget=k)
    tdrs, tmeta = tm.to_device(tcps, "cpu", prune_budget=k)
    want = jm._classify_jit(jdrs, *args, meta=jmeta, fused=fused)
    before = (tc.launches, tpc.launches)
    got = tm.classify_batch(tdrs, *(_t(a) for a in args), meta=tmeta,
                            fused=fused)
    assert (tc.launches, tpc.launches) == before
    for key in _KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["prune_skip"].any() and not got["prune_skip"].all()
    if k == 1:
        assert got["prune_fb"].any()  # S_in = 2 > K: the fallback fires
    # Pruning never changes a verdict: the port's unpruned walk agrees.
    udrs, umeta = tm.to_device(tcps, "cpu")
    plain = tm.classify_batch(udrs, *(_t(a) for a in args), meta=umeta,
                              fused=fused)
    for key in _KEYS[:5]:
        assert torch.equal(got[key], plain[key]), key
    assert (plain["ingress_rule"] >= 0).any()


def test_classify_pruned_svcref_equals_reference(world):
    """The toServices second svc probe ORed into the aggregate and the
    candidate words (forced on, as in tests/test_torch_match.py)."""
    jc, jcps, tcps = world
    tr = j_gen_traffic(jc.pod_ips, 256, n_flows=256, seed=7)
    args = (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip),
            tr.proto.astype(np.int32), tr.dst_port.astype(np.int32))
    svc_ref = np.random.default_rng(7).integers(-1, 40, 256).astype(np.int32)
    jdrs, jmeta = jm.to_device(jcps, prune_budget=1)
    tdrs, tmeta = tm.to_device(tcps, "cpu", prune_budget=1)
    want = jm._classify_jit(jdrs, *args, meta=jmeta._replace(svcref=True),
                            fused=False, svc_ref=svc_ref)
    got = tm.classify_batch(tdrs, *(_t(a) for a in args),
                            meta=tmeta._replace(svcref=True), fused=False,
                            svc_ref=_t(svc_ref))
    for key in _KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_classify_pruned_all_dead_batch(world):
    """Lanes whose aggregate AND is zero in both directions take the
    default verdicts without a candidate scan."""
    _, jcps, tcps = world
    tdrs, tmeta = tm.to_device(tcps, "cpu", prune_budget=2)
    jdrs, jmeta = jm.to_device(jcps, prune_budget=2)
    # Addresses outside every group, a port no rule names.
    ip = iputil.flip_u32(np.full(8, 0xFE000001, np.uint32))
    args = (ip, ip, np.full(8, 17, np.int32), np.full(8, 9, np.int32))
    want = jm._classify_jit(jdrs, *args, meta=jmeta, fused=False)
    got = tm.classify_batch(tdrs, *(_t(a) for a in args), meta=tmeta,
                            fused=True)
    assert bool(got["prune_skip"].all())
    for key in _KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
