"""The PyTorch port's classifier against the JAX package, on the CPU.

Same numpy-seeded inputs through both; every compared value is an int32 or
u32 word, so the tolerance is exact equality.  The JAX side runs its Pallas
consumer in interpret mode, as its own tests do on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antrea_tpu.compiler.compile import compile_policy_set as j_compile
from antrea_tpu.ops import hashing as jhash
from antrea_tpu.ops import match as jm
from antrea_tpu.simulator import gen_cluster as j_gen_cluster
from antrea_tpu.simulator import gen_traffic as j_gen_traffic
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.compiler.compile import compile_policy_set as t_compile
from antrea_tpu_torch.ops import consumer as tc
from antrea_tpu_torch.ops import hashing as thash
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.simulator import gen_cluster as t_gen_cluster
import torch_cpu  # noqa: F401  (one torch thread a worker)

_KEYS = ("code", "egress_code", "egress_rule", "ingress_code", "ingress_rule")


def _t(a) -> torch.Tensor:
    """numpy u32/i32 -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32))


@pytest.fixture(scope="module")
def world():
    """The small world of tests/test_fused_consumer.py, built by each
    package from its own generator and compiler."""
    kw = dict(n_nodes=8, pods_per_node=8, seed=5)
    jc = j_gen_cluster(600, **kw)
    tcl = t_gen_cluster(600, **kw)
    return jc, j_compile(jc.ps), t_compile(tcl.ps)


def _leaves(tree, prefix=""):
    if tree is None:
        return [(prefix, None)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _leaves(getattr(tree, f), f"{prefix}.{f}")
        return out
    return [(prefix, tree)]


def test_to_host_equals_reference(world):
    _, jcps, tcps = world
    jdrs, jmeta = jm.to_host(jcps)
    tdrs, tmeta = tm.to_host(tcps)
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
    # Device tables keep the u32 bits in int32.
    drs, _ = tm.to_device(tcps, "cpu")
    inc = drs.ingress.peer.inc
    assert inc.dtype == torch.int32
    np.testing.assert_array_equal(inc.numpy().view(np.uint32),
                                  jdrs.ingress.peer.inc)


def test_flow_hash_equals_reference():
    rng = np.random.default_rng(11)
    n = 4096
    src = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    dst = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    src[:4] = [0, 2**31, 2**32 - 1, 2**31 - 1]
    proto = rng.integers(0, 256, n).astype(np.int32)
    sport = rng.integers(0, 65536, n).astype(np.int32)
    dport = rng.integers(0, 65536, n).astype(np.int32)
    assert (src >= 2**31).any() and (sport >= 32768).any()
    want = jhash.flow_hash(src.view(np.int32), dst.view(np.int32), proto,
                           sport, dport)
    got = thash.flow_hash(_t(src), _t(dst), _t(proto), _t(sport), _t(dport))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    want2 = jhash.fnv_mix([src.view(np.int32), dport])
    got2 = thash.fnv_mix([_t(src), _t(dport)])
    np.testing.assert_array_equal(got2.numpy(), want2.astype(np.int64))


def _bit_rows(rng, b, w, dens):
    """(b, w) u32 words, lane i's bits set with probability dens[i]."""
    bits = rng.random((b, w, 32)) < np.asarray(dens)[:, None, None]
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=2).astype(np.uint32)


# (id, B, w_in, w_out, in_phases, out_phases, (w0_in, w0_out) or None)
_CONSUMER_CASES = [
    ("bounds-inside-words", 128, 5, 3, (37, 50, 60), (21, 30, 40), None),
    ("bounds-on-word-edges", 128, 6, 4, (64, 32, 96), (32, 64, 32), None),
    ("empty-phases", 128, 5, 3, (0, 70, 90), (40, 0, 56), None),
    ("ragged-batch", 37, 5, 3, (37, 50, 60), (21, 30, 40), None),
    ("global-word-offsets", 128, 5, 3, (130, 50, 60), (21, 300, 40), (3, 7)),
]


@pytest.mark.parametrize("case", _CONSUMER_CASES, ids=lambda c: c[0])
def test_plain_consumer_equals_pallas_consumer(case):
    _, b, w_in, w_out, in_ph, out_ph, w0 = case
    rng = np.random.default_rng(b * 31 + w_in)
    # Per-lane row densities: all-zero lanes, sparse ANDs whose first hit
    # lies deep in the row, and dense ones.
    dens = [(0.0, 0.2, 0.5, 0.9)[i % 4] for i in range(b)]
    rows_in = [_bit_rows(rng, b, w_in, np.roll(dens, k)) for k in range(3)]
    rows_out = [_bit_rows(rng, b, w_out, np.roll(dens, k)) for k in range(3)]
    meta = jm.StaticMeta(in_phases=in_ph, out_phases=out_ph, w_in=w_in,
                         w_out=w_out, fused_interpret=True)
    w0_in, w0_out = w0 if w0 is not None else (0, 0)
    jin, jout = jm._fused_hits(
        tuple(jnp.asarray(r) for r in rows_in),
        tuple(jnp.asarray(r) for r in rows_out), meta,
        w0_in=None if w0 is None else jnp.int32(w0_in),
        w0_out=None if w0 is None else jnp.int32(w0_out))
    want = np.stack([np.asarray(h) for h in (*jin, *jout)], axis=1)

    # The port reads the same rows from tables at the lanes' interval rows:
    # each row matrix becomes a table whose rows are the lanes' rows in a
    # seeded order, and iv holds each lane's row in it.
    perm = [rng.permutation(b) for _ in range(6)]
    tabs = [np.empty_like(r) for r in (*rows_in, *rows_out)]
    for t, r, p in zip(tabs, (*rows_in, *rows_out), perm):
        t[p] = r
    iv = np.zeros((b, 8), np.int32)
    iv[:, :6] = np.stack(perm, axis=1)
    before = tc.launches
    got = tc.fused_hits(tuple(_t(t) for t in tabs), _t(iv), False, in_ph,
                        out_ph, w0_in, w0_out)
    assert tc.launches == before  # CPU tensors never launch the kernel
    assert got.shape == (b, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[:, :6].numpy(), want)
    assert not got[:, 6:].any()
    assert (want < tc.BIG).any() and (want == tc.BIG).any()


def test_consumer_wrapper_checks_its_inputs():
    z = torch.zeros((4, 3), dtype=torch.int32)
    iv = torch.zeros((5, 8), dtype=torch.int32)
    tabs = (z, z, z, z[:, :2].contiguous(), z[:, :2].contiguous(),
            z[:, :2].contiguous())
    ph = (10, 10, 10)
    got = tc.fused_hits(tabs, iv, True, ph, ph)
    assert got.shape == (5, 8) and got.dtype == torch.int32
    assert got.device == iv.device and got.is_contiguous()
    with pytest.raises(TypeError):  # an int64 table
        tc.fused_hits((z, z, z.long(), *tabs[3:]), iv, False, ph, ph)
    with pytest.raises(TypeError):  # int64 interval rows
        tc.fused_hits(tabs, iv.long(), False, ph, ph)
    with pytest.raises(ValueError):  # iv not (B, 8)
        tc.fused_hits(tabs, iv[:, :6].contiguous(), False, ph, ph)
    with pytest.raises(ValueError):  # iv not contiguous
        tc.fused_hits(tabs, torch.zeros((8, 5), dtype=torch.int32).t(),
                      False, ph, ph)
    with pytest.raises(ValueError):  # a table not contiguous
        tc.fused_hits((z, z, z.t().contiguous().t(), *tabs[3:]), iv, False,
                      ph, ph)
    with pytest.raises(ValueError):  # ingress widths disagree
        tc.fused_hits((z, z, z[:, :2].contiguous(), *tabs[3:]), iv, False,
                      ph, ph)
    with pytest.raises(ValueError):  # five tables
        tc.fused_hits(tabs[:5], iv, False, ph, ph)
    with pytest.raises(ValueError):  # a table on another device
        tc.fused_hits((z.to("meta"), *tabs[1:]), iv, False, ph, ph)


def _table_case(name, rng):
    """-> (six u32 tables, in_phases, out_phases, (w0_in, w0_out)): the
    small world's own tables (to_host of the JAX package), or seeded tables
    of odd widths."""
    if name == "world":
        kw = dict(n_nodes=8, pods_per_node=8, seed=5)
        jdrs, jmeta = jm.to_host(j_compile(j_gen_cluster(600, **kw).ps))
        tabs = [t.inc for d in (jdrs.ingress, jdrs.egress)
                for t in (d.at, d.peer, d.svc)]
        return tabs, jmeta.in_phases, jmeta.out_phases, (0, 0)
    w_in, w_out, w0 = {"odd-widths": (5, 61, (0, 0)),
                       "word-offsets": (7, 3, (3, 11))}[name]
    tabs = [_bit_rows(rng, n, w, [0.5] * n)
            for n, w in ((9, w_in), (13, w_in), (6, w_in), (11, w_out),
                         (7, w_out), (10, w_out))]
    n_in, n_out = 32 * w_in, 32 * w_out
    return (tabs, (n_in // 3, n_in // 4, n_in), (n_out // 5, n_out // 2,
                                                 n_out), w0)


# (id, tables, B, svcref)
_TABLE_CASES = [
    ("world", "world", 128, False),
    ("world-svcref", "world", 128, True),
    ("world-ragged", "world", 37, True),
    ("odd-widths", "odd-widths", 37, True),
    ("odd-widths-plain", "odd-widths", 64, False),
    ("word-offsets", "word-offsets", 37, True),
]


@pytest.mark.parametrize("case", _TABLE_CASES, ids=lambda c: c[0])
def test_fused_hits_from_tables_equals_pallas(case):
    """B1's entry (tables + interval rows) against the JAX _fused_hits in
    interpret mode on rows that JAX gathers itself from the same tables at
    the same numpy iv; iv holds row 0 and the last row of every table."""
    _, tables, b, svcref = case
    rng = np.random.default_rng(b + len(tables))
    tabs, in_ph, out_ph, (w0_in, w0_out) = _table_case(tables, rng)
    iv = np.zeros((b, 8), np.int32)
    for k in range(7):
        n = tabs[min(k, 5)].shape[0]
        iv[:, k] = rng.integers(0, n, b)
        iv[k % 4, k] = 0
        iv[4 + k % 4, k] = n - 1

    jt = [jnp.asarray(t) for t in tabs]
    rows = [t[jnp.asarray(iv[:, k])] for k, t in enumerate(jt)]
    if svcref:
        rows[5] = rows[5] | jt[5][jnp.asarray(iv[:, 6])]
    meta = jm.StaticMeta(in_phases=in_ph, out_phases=out_ph,
                         w_in=tabs[0].shape[1], w_out=tabs[3].shape[1],
                         fused_interpret=True)
    offsets = w0_in or w0_out
    jin, jout = jm._fused_hits(
        tuple(rows[:3]), tuple(rows[3:]), meta,
        w0_in=jnp.int32(w0_in) if offsets else None,
        w0_out=jnp.int32(w0_out) if offsets else None)
    want = np.stack([np.asarray(h) for h in (*jin, *jout)], axis=1)

    before = tc.launches
    got = tc.fused_hits(tuple(_t(t) for t in tabs), _t(iv), svcref, in_ph,
                        out_ph, w0_in, w0_out)
    assert tc.launches == before  # CPU tensors never launch the kernel
    assert got.shape == (b, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[:, :6].numpy(), want)
    assert not got[:, 6:].any()
    assert (want < tc.BIG).any()


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
@pytest.mark.parametrize("svcref", [False, True], ids=["plain", "svcref"])
def test_classify_batch_equals_reference(world, fused, svcref):
    jc, jcps, tcps = world
    tr = j_gen_traffic(jc.pod_ips, 256, n_flows=256, seed=6)
    args = (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip),
            tr.proto.astype(np.int32), tr.dst_port.astype(np.int32))
    jdrs, jmeta = jm.to_device(jcps)
    tdrs, tmeta = tm.to_device(tcps, "cpu")
    svc_ref = None
    if svcref:
        # Force the toServices probe on: both sides then OR a second egress
        # svc row keyed by the lane's service reference.
        jmeta = jmeta._replace(svcref=True)
        tmeta = tmeta._replace(svcref=True)
        svc_ref = np.random.default_rng(7).integers(-1, 40, 256).astype(
            np.int32)
    want = jm._classify_jit(jdrs, *args, meta=jmeta, fused=fused,
                            svc_ref=svc_ref)
    got = tm.classify_batch(
        tdrs, *(_t(a) for a in args), meta=tmeta, fused=fused,
        svc_ref=None if svc_ref is None else _t(svc_ref))
    for k in _KEYS:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert (got["ingress_rule"] >= 0).any() and (got["egress_rule"] >= 0).any()


def test_make_classifier_runs_on_cpu(world):
    jc, jcps, tcps = world
    tr = j_gen_traffic(jc.pod_ips, 64, n_flows=64, seed=8)
    args = (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip),
            tr.proto.astype(np.int32), tr.dst_port.astype(np.int32))
    jfn, _ = jm.make_classifier(jcps)
    tfn, tdrs = tm.make_classifier(tcps, device="cpu")
    assert tdrs.ingress.at.inc.device.type == "cpu"
    want, got = jfn(*args), tfn(*args)
    for k in _KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
