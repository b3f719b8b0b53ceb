"""The PyTorch port's one-pass pipeline step and its B3 kernel's plain
version against the JAX package, on the CPU.  The JAX side runs its Pallas
one-pass kernel in interpret mode, as its own tests do.  Every value is an
int32 or u32 word: the tolerance is exact equality, and after every step
every output key and every flow-cache and affinity column must be equal
(the dump row excluded).

One world and one set of shapes (B = 120 lanes, padded to 128 on the JAX
side, K = 1, 2**10 slots) serve every test, so the JAX package's compiled
one-pass kernel is shared between them; the B3 edge cases add one more
compile (256 lanes, the toServices probe on)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antrea_tpu.compiler.compile import (SVCREF_BASE, SVCREF_NONE,
                                         compile_policy_set)
from antrea_tpu.compiler.services import compile_services
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.ops import match as jm
from antrea_tpu.simulator import gen_cluster, gen_services, gen_traffic
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.compiler.compile import compile_policy_set as t_compile
from antrea_tpu_torch.compiler.services import \
    compile_services as t_compile_services
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.ops import consumer as tc
from antrea_tpu_torch.ops import hashing as thash
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.ops import onepass as top
from antrea_tpu_torch.ops import pruned_consumer as tpc
from antrea_tpu_torch.simulator import gen_cluster as t_gen_cluster
from antrea_tpu_torch.simulator import gen_services as t_gen_services
import torch_cpu  # noqa: F401  (one torch thread a worker)

B = 120
K = 1
KW = dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=64, fused=True,
          prune_budget=K)


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32))


def _lanes(tr):
    return (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip),
            tr.proto.astype(np.int32), tr.src_port.astype(np.int32),
            tr.dst_port.astype(np.int32))


@pytest.fixture(scope="module")
def world():
    """A 2500-rule world on 64 pods (S_in = 2 > K, so the fallback fires;
    a third of the lanes are allowed), with affinity services and services
    without endpoints."""
    kw = dict(n_nodes=8, pods_per_node=8, seed=12)
    cluster = gen_cluster(2500, **kw)
    services = gen_services(40, cluster.pod_ips, affinity_fraction=0.3,
                            no_ep_fraction=0.1, seed=4)
    assert any(s.affinity_timeout_s > 0 for s in services)
    assert any(not s.endpoints for s in services)
    tcl = t_gen_cluster(2500, **kw)
    tsvcs = t_gen_services(40, tcl.pod_ips, affinity_fraction=0.3,
                           no_ep_fraction=0.1, seed=4)
    return (cluster, services, compile_policy_set(cluster.ps),
            compile_services(services), t_compile(tcl.ps),
            t_compile_services(tsvcs))


def _traffic(cluster, services, seed, n_flows=96):
    return _lanes(gen_traffic(cluster.pod_ips, B, n_flows=n_flows, seed=seed,
                              services=services, svc_fraction=0.3))


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
            want = np.asarray(getattr(jt, f))[:-1]  # dump row excluded
            got = getattr(tt, f).numpy()[:-1]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{what}: {part}.{f}")


def _twins(world, **knobs):
    """The JAX step and the port's step on the same tables and initial
    state; the port's own make_pipeline gives the static meta."""
    cluster, services, cps, svc, tcps, tsvc = world
    kw = dict(KW, **knobs)
    jstep, jstate, (jdrs, jdsvc) = jpl.make_pipeline(cps, svc, **kw)
    drs_np, _ = jm.to_host(cps, prune_budget=K)
    tdrs = tm.ruleset_from_numpy(drs_np, "cpu")
    tdsvc = tpl.services_from_numpy(jpl.svc_to_host(svc), "cpu")
    tstate = tpl.state_from_numpy(jax.device_get(jstate), "cpu")
    tstep, _, _ = tpl.make_pipeline(tcps, tsvc, device="cpu", **kw)
    jmm = jstep.meta.match
    assert tstep.meta.match == tm.StaticMeta(
        jmm.in_phases, jmm.out_phases, jmm.w_in, jmm.w_out, jmm.svcref, K)
    assert tstep.meta.onepass == jstep.meta.onepass
    zero = np.zeros(B, np.int32)
    st = {"j": jstate, "t": tstate}

    def run(lanes, now, gen=0, flags=None, what=""):
        st["j"], jout = jpl.pipeline_step(
            st["j"], jdrs, jdsvc, *lanes, now, gen, meta=jstep.meta,
            flags=zero if flags is None else flags)
        before = (tc.launches, tpc.launches, top.launches)
        st["t"], tout = tstep(st["t"], tdrs, tdsvc, *(_t(a) for a in lanes),
                              now, gen,
                              flags=None if flags is None else _t(flags))
        # CPU tensors run the plain versions: no kernel launches.
        assert (tc.launches, tpc.launches, top.launches) == before
        _compare(st["j"], jout, st["t"], tout, what)
        return {k: v.numpy() for k, v in tout.items()}

    return run, st


def test_onepass_pipeline_equals_reference(world):
    cluster, services = world[:2]
    run, st = _twins(world)
    fwd = _traffic(cluster, services, seed=3)
    cold = run(fwd, 100, what="cold")
    assert cold["n_miss"] == B and cold["committed"].any()
    assert (cold["code"] == 2).any() and (cold["svc_idx"] >= 0).any()
    assert cold["n_prune_fb"] > 0 and cold["n_prune_skips"] > 0
    assert cold["prune_cand_hist"][:-1].sum() == B
    warm = run(fwd, 101, what="warm")
    assert warm["est"].any() and 0 < warm["n_miss"] < B
    # Past ct_timeout_s/2: established hits refresh their partners.
    run(fwd, 1902, what="partner refresh")
    zc = st["t"].flow.meta[:-1, 3]
    assert ((zc & tpl.PREF_MASK) == 1902).any()
    # Reply tuples of the committed flows CONFIRM both directions.
    c = cold["committed"] == 1
    reply = (np.where(c, cold["dnat_ip_f"], fwd[0]),
             np.where(c, fwd[0], fwd[1]), fwd[2],
             np.where(c, cold["dnat_port"], fwd[3]),
             np.where(c, fwd[3], fwd[4]))
    rep = run(reply, 1903, what="reply/confirm")
    assert rep["reply"].any()
    # FIN on every other lane tears established TCP entries down; the
    # kernel's probe must read the rows as gathered before the teardown.
    fin = np.where(np.arange(B) % 2 == 0, tpl.TCP_FIN, 0).astype(np.int32)
    live = (st["t"].flow.keys[:-1, 3] != 0).sum()
    run(fwd, 1904, flags=fin, what="teardown")
    assert (st["t"].flow.keys[:-1, 3] != 0).sum() < live
    # Every entry expired: the whole batch takes the one-pass slow path
    # over a full cache (the cold_fused regime), with evictions.
    out = run(fwd, 1904 + 2 * 3600, what="expire-all")
    assert out["n_miss"] == B and out["n_evict"] > 0


def test_staged_pruned_pipeline_equals_reference(world):
    """onepass=False pins the miss rounds through the pruned classify
    (B2), as bench_profile's prune mode does."""
    cluster, services = world[:2]
    run, _ = _twins(world, onepass=False)
    fwd = _traffic(cluster, services, seed=3)
    cold = run(fwd, 100, what="staged cold")
    assert cold["n_prune_fb"] > 0 and cold["n_miss"] > KW["miss_chunk"]
    run(fwd, 101, what="staged warm")
    churn = _traffic(cluster, services, seed=9, n_flows=4096)
    out = run(churn, 102, gen=1, what="staged churn")
    assert out["n_miss"] > 0


def _np_probes(dims, iso, x, miss, prog_svc=None):
    """B3's probes made with numpy from host tables: dims the six DimTables
    (ingress at/peer/svc, egress at/peer/svc), iso the two IsoTables, x the
    lane inputs, prog_svc for the toServices probe (None: off).  Non-miss
    lanes take row 0.  -> (iv (B, 8) with column 7 zero, as the Pallas
    kernel takes it; the six aggregate rows, svcref ORed; prb (B, 4)
    [ts, iso_in, iso_out, 0]; the isolation column iso_in | iso_out << 1
    of the port's iv)."""
    pkt, lb = x.pkt.numpy(), x.lb.numpy()
    src, proto = pkt[:, 0], pkt[:, 2]
    svc_idx, dnat, dnat_port = lb[:, 0], lb[:, 2], lb[:, 3]
    svc_key = ((proto << 16) | dnat_port).astype(np.int32)

    def midx(bounds, key):
        return np.where(miss, np.searchsorted(bounds, key, side="right"), 0)

    keys = (dnat, src, svc_key, src, dnat, svc_key)
    rows = [midx(t.bounds, k) for t, k in zip(dims, keys)]
    aggs = [np.asarray(t.agg)[r] for t, r in zip(dims, rows)]
    ref_row = np.zeros_like(rows[0])
    if prog_svc is not None:
        ref = np.where(svc_idx >= 0,
                       prog_svc[np.clip(svc_idx, 0, len(prog_svc) - 1)], -1)
        ref_key = np.where(ref >= 0, SVCREF_BASE + ref,
                           SVCREF_NONE).astype(np.int32)
        ref_row = midx(dims[5].bounds, ref_key)
        aggs[5] = aggs[5] | np.asarray(dims[5].agg)[ref_row]
    iso_in = np.asarray(iso[0].val)[midx(iso[0].bounds, dnat)]
    iso_out = np.asarray(iso[1].val)[midx(iso[1].bounds, src)]
    z = np.zeros_like(src)
    iv = np.stack([*rows, ref_row, z], axis=1).astype(np.int32)
    prb = np.stack([x.ts.numpy(), iso_in, iso_out, z], axis=1)
    return (iv, [np.ascontiguousarray(a) for a in aggs], prb,
            np.where(miss, iso_in | (iso_out << 1), 0))


def _pallas(x, dims, iso, act, miss, meta, k, now, gen_w, prog_svc=None,
            pref_mask=tpl.PREF_MASK):
    """The JAX package's one-pass kernel (interpret mode) on x, with its
    probes made by _np_probes -> ((main, keys8, meta8, aux) numpy, the
    numpy iv and isolation column)."""
    b = x.pkt.shape[0]
    bp = -(-b // 128) * 128
    iv, aggs, prb, iso_col = _np_probes(dims, iso, x, miss, prog_svc)

    def pad(a, u32=False):
        a = np.pad(np.asarray(a), ((0, bp - b), (0, 0)))
        return jnp.asarray(a.view(np.uint32) if u32 else a)

    mm = meta.match
    s_in, s_out = aggs[0].shape[1], aggs[3].shape[1]
    call = jm._onepass_call(bp, s_in, s_out, k, k, mm.in_phases,
                            mm.out_phases, prog_svc is not None, True,
                            meta.timeouts, meta.flow_slots, pref_mask, True)
    scal = jnp.asarray([[now, gen_w, 0, 0]], jnp.int32)
    inc2 = [jnp.asarray(np.asarray(t.inc).view(np.uint32).reshape(-1, 32))
            for t in dims]
    if prog_svc is not None:
        inc2.append(inc2[5])  # the svcref row's source: egress svc again
    want = call(pad(x.pkt.numpy()), pad(x.kr.numpy()), pad(prb),
                pad(x.mrow.numpy()), pad(x.msk.numpy()), pad(x.lb.numpy()),
                *(pad(a, u32=True) for a in aggs), pad(iv), scal, *inc2,
                jnp.asarray(act[0]), jnp.asarray(act[1]))
    return [np.asarray(w)[:b] for w in want], iv, iso_col


def _assert_b3(got, want, iv, iso_col, what):
    for name, g, w in zip(("main", "keys8", "meta8", "aux"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {name}")
    np.testing.assert_array_equal(got[4][:, :7].numpy(), iv[:, :7],
                                  err_msg=f"{what} iv")
    np.testing.assert_array_equal(got[4][:, 7].numpy(), iso_col,
                                  err_msg=f"{what} iv isolation column")


@pytest.fixture(scope="module")
def b3(world):
    """The port's one-pass pipeline after a cold step at now = 100, the
    JAX package's host tables of the same rule set, and a probe helper:
    lanes -> (B3's inputs against the warm state at now = 101, the probe
    hit mask)."""
    cluster, services, cps, svc, tcps, tsvc = world
    step, state, (drs, dsvc) = tpl.make_pipeline(tcps, tsvc, device="cpu",
                                                 **KW)
    fwd = [_t(a) for a in _traffic(cluster, services, seed=3)]
    state, _ = step(state, drs, dsvc, *fwd, 100, 0)
    meta = step.meta
    drs_np, _ = jm.to_host(cps, prune_budget=K)

    def inputs(lanes, now=101, gen_w=0):
        src_f, dst_f, proto, sport, dport = lanes
        pp = tpl._pair16(sport, dport)
        h = thash.flow_hash(tpl._raw_bits(src_f), tpl._raw_bits(dst_f),
                            proto, sport, dport)
        slot = h & (meta.flow_slots - 1)
        hit, _, _, mr, kr0, ts0 = tpl._cache_lookup(
            state.flow, slot, torch.stack([src_f, dst_f], 1), pp,
            proto | 0x100 | (gen_w << 9),
            proto | 0x100 | (tpl.GEN_ETERNAL << 9), now, proto, meta)
        x, tabs, st, _ = tpl._onepass_inputs(
            state.aff, drs, dsvc, src_f, dst_f, proto, sport, dport, pp, h,
            kr0, mr, ts0, now, meta)
        return x, tabs, st, hit.numpy()

    ing, eg = drs_np.ingress, drs_np.egress
    host = dict(dims=(ing.at, ing.peer, ing.svc, eg.at, eg.peer, eg.svc),
                iso=(drs_np.iso_in, drs_np.iso_out),
                act=(np.asarray(ing.action), np.asarray(eg.action)),
                prog_svc=np.asarray(jpl.svc_to_host(svc).prog_svc))
    return dict(meta=meta, fwd=fwd, inputs=inputs, host=host)


def test_plain_onepass_equals_pallas(world, b3):
    """B3's plain version against the Pallas kernel (interpret mode), after
    a cold step, so the batch has hit, miss, skip, fallback and no-endpoint
    lanes.  The Pallas kernel gets its interval rows, aggregate rows and
    isolation bits from numpy (searchsorted on the JAX package's host
    bounds, non-miss lanes on row 0); the port's plain version runs its own
    probes, and its iv output must equal numpy's.  The port's batch is
    ragged; the JAX kernel takes 128 lanes."""
    cluster, services = world[:2]
    lanes = [torch.cat([a[:B // 2], b[B // 2:]]) for a, b in zip(
        b3["fwd"], (_t(a) for a in _traffic(cluster, services, seed=5)))]
    x, tabs, st, hit = b3["inputs"](lanes)
    got = top.onepass(x, tabs, 101, 0, st)
    host = b3["host"]
    want, iv, iso_col = _pallas(x, host["dims"], host["iso"], host["act"],
                                ~hit, b3["meta"], K, 101, 0)
    _assert_b3(got, want, iv, iso_col, "half-warm")
    main, aux = got[0].numpy(), got[3].numpy()
    np.testing.assert_array_equal(main[:, 11], hit)
    assert hit.any() and not hit.all()  # hit and miss lanes
    assert aux[:, 0].any() and aux[:, 1].any()  # skip and fallback lanes
    assert (main[:, 0] == 2).any()  # no-endpoint REJECT lanes


def _svcref_dim(t, refs, rng):
    """The DimTable t (host) with interval bounds at SVCREF_BASE + r and
    SVCREF_BASE + r + 1 for each r in refs inserted after its v4 space: a
    toServices-bearing egress svc table.  Each new row copies a v4 row with
    a nonzero aggregate row, chosen by rng."""
    base = SVCREF_BASE
    bounds = np.asarray(t.bounds)
    new = np.unique(np.concatenate([[base + r, base + r + 1] for r in refs]))
    n4 = bounds.shape[0]
    agg, inc = np.asarray(t.agg), np.asarray(t.inc)
    full = np.flatnonzero(agg[:n4 + 1].any(axis=1))
    pick = rng.choice(full, size=new.shape[0])
    rows = np.concatenate([np.arange(n4 + 1), pick,
                           np.arange(n4 + 1, agg.shape[0])])
    return t._replace(bounds=np.concatenate([bounds, new]).astype(np.int32),
                      agg=agg[rows], inc=inc[rows])


def test_plain_onepass_edge_cases_equal_pallas(world, b3):
    """One more Pallas call, 256 lanes: an all-hit tile (the warm lanes of
    the cold step's batch) and a miss tile whose keys lie below the first
    bound and above the last of the tables, with service lanes; the
    toServices probe on (egress svc extended with reference intervals, the
    world's prog_svc) and iso_in.val[0] = 1, so every hit lane's fresh code
    in meta8 reads isolation row 0.  Lanes of both tiles carry the msk bits
    the step sets from its lane masks: valid = 0 (one of them a lane that
    would hit), no_commit = 1, and fb_force = 1.  The call runs at second
    chance's stamp mask (PREF_MASK_CHANCE) with now past 2**28 (ts shifted
    with it, so every lane keeps its age), and half the hit lanes' meta3
    carry collision-counter bits.  The all-hit tile alone is also run
    through the plain version as a batch of its own."""
    cluster, services = world[:2]
    host = b3["host"]
    rng = np.random.default_rng(11)
    _, _, _, hit0 = b3["inputs"](b3["fwd"])
    warm = np.flatnonzero(hit0)
    hot = [a[torch.from_numpy(warm[np.arange(128) % warm.size])]
           for a in b3["fwd"]]
    # Keys at and beside the first and last bound of every IP table, and
    # the address space's ends.
    ip_tabs = [host["dims"][i] for i in (0, 1, 3, 4)] + list(host["iso"])
    edge = {np.iinfo(np.int32).min, np.iinfo(np.int32).max}
    for t in ip_tabs:
        bd = np.asarray(t.bounds)
        edge |= {int(bd[0]) - 1, int(bd[0]), int(bd[-1]) - 1, int(bd[-1])}
    edge = np.array(sorted(v for v in edge
                           if -2**31 <= v < 2**31), dtype=np.int32)
    fresh = _traffic(cluster, services, seed=17)
    n = edge.size
    cold = [np.asarray(c[:128]).copy() for c in fresh]
    cold[0][:n] = edge
    cold[1][:n] = edge[::-1]
    cold[4][:n:2] = 0
    cold[4][1:n:2] = 65535
    lanes = [torch.cat([h, _t(c)]) for h, c in zip(hot, cold)]

    x, tabs, st, hit = b3["inputs"](lanes)
    assert hit[:128].all() and not hit[128:].any()
    # msk bits, on lanes past the edge keys: valid = 0, no_commit = 1 and
    # fb_force = 1 (some lanes with two of them).
    msk = x.msk.clone()
    msk[[5, 230, 231, 232], 0] = 0
    msk[[7, 232, 236, 237, 238], 1] = 1
    msk[[236, 240, 241, 242], 2] = 1
    now = 101 + (1 << 28)
    mrow = x.mrow.clone()
    mrow[:64:2, 3] |= tpl.CHANCE_MASK
    x = x._replace(msk=msk, ts=x.ts + (1 << 28), mrow=mrow)
    valid = msk[:, 0].numpy() != 0
    refs = np.unique(host["prog_svc"][x.lb[128:, 0].numpy()[
        x.lb[128:, 0].numpy() >= 0]])[:4]
    assert refs.size > 0
    dims = list(host["dims"])
    dims[5] = _svcref_dim(dims[5], refs, rng)
    iso = [host["iso"][0]._replace(val=np.asarray(host["iso"][0].val).copy()),
           host["iso"][1]]
    iso[0].val[0] = 1
    tabs = tabs._replace(
        bounds=tuple(_t(t.bounds) for t in dims),
        agg=tuple(_t(t.agg) for t in dims),
        inc=tuple(_t(t.inc) for t in dims),
        iso_val=(_t(iso[0].val), tabs.iso_val[1]),
        prog_svc=_t(host["prog_svc"]))
    st = st._replace(svcref=True, pref_mask=tpl.PREF_MASK_CHANCE)
    want, iv, iso_col = _pallas(x, dims, iso, host["act"], ~hit & valid,
                                b3["meta"], K, now, 0,
                                prog_svc=host["prog_svc"],
                                pref_mask=tpl.PREF_MASK_CHANCE)
    _assert_b3(top.onepass(x, tabs, now, 0, st), want, iv, iso_col,
               "edge cases")
    main, aux = want[0], want[3]
    # valid = 0: neither hit nor miss, the plain ALLOW image, nothing
    # inserted; no_commit = 1: classified, not committed; fb_force = 1: a
    # fallback lane.
    assert (main[~valid][:, [0, 11, 14]] == 0).all()
    assert (main[[7, 236, 237, 238], 14] == 0).all()
    assert (main[[236, 237, 238], 8] == 0).all()
    assert (aux[[236, 240, 241, 242], 1] == 1).all()
    # The committed rows' stamps are now under the narrowed mask.
    ins = main[:, 14] != 0
    assert ins.any()
    assert (want[2][ins, 3] & tpl.PREF_MASK == now & tpl.PREF_MASK_CHANCE
            ).all()
    x_hot = top.OnepassInputs(*(t[:128] for t in x))
    _assert_b3(top.onepass(x_hot, tabs, now, 0, st), [w[:128] for w in want],
               iv[:128], iso_col[:128], "all-hit batch")
    # The searches reached both ends of the tables, and the toServices
    # rows inserted above.
    miss = ~hit & valid
    ends = [(iv[miss, i] == 0).any() and (iv[miss, i] == len(d.bounds)).any()
            for i, d in enumerate(dims)]
    assert sum(ends) >= 2, ends
    assert (iv[miss, 6] > len(host["dims"][5].bounds)).any()
    # Hit lanes: iso_in row 0 isolates them, so their fresh code is a DROP
    # (a REJECT where the service has no endpoint).
    f_code = want[2][:128, 1] & 3
    no_ep = x.lb[:128, 1].numpy() != 0
    assert (f_code[~no_ep] == 1).all() and (~no_ep).any()


def test_onepass_wrapper_checks(b3):
    """B3's wrapper refuses what the kernel cannot take, on the CPU as on
    the card: a lane input of another type or shape, a table with fewer
    rows than intervals, the toServices probe without prog_svc; and a table
    swapped in after an accepted call is checked again."""
    x, tabs, st, _ = b3["inputs"](b3["fwd"])
    top.onepass(x, tabs, 101, 0, st)  # accepted: its tables are remembered
    with pytest.raises(TypeError, match="ts"):
        top.onepass(x._replace(ts=x.ts.long()), tabs, 101, 0, st)
    with pytest.raises(ValueError, match="pkt"):
        top.onepass(x._replace(pkt=x.pkt[:, :7].contiguous()), tabs, 101, 0,
                    st)
    short = tabs._replace(agg=(tabs.agg[0][:1],) + tabs.agg[1:],
                          inc=(tabs.inc[0][:1],) + tabs.inc[1:])
    with pytest.raises(ValueError, match="row per interval"):
        top.onepass(x, short, 101, 0, st)
    with pytest.raises(ValueError, match="prog_svc"):
        top.onepass(x, tabs._replace(prog_svc=None), 101, 0,
                    st._replace(svcref=True))
    wide = tabs._replace(act_in=tabs.act_in.long())
    with pytest.raises(TypeError, match="act_in"):
        top.onepass(x, wide, 101, 0, st)
