"""The PyTorch port's one-pass pipeline step and its B3 kernel's plain
version against the JAX package, on the CPU.  The JAX side runs its Pallas
one-pass kernel in interpret mode, as its own tests do.  Every value is an
int32 or u32 word: the tolerance is exact equality, and after every step
every output key and every flow-cache and affinity column must be equal
(the dump row excluded).

One world and one set of shapes (B = 120 lanes, padded to 128 on the JAX
side, K = 1, 2**10 slots) serve every test, so the JAX package's compiled
one-pass kernel is shared between them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antrea_tpu.compiler.compile import compile_policy_set
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


def test_plain_onepass_equals_pallas(world):
    """B3's plain version against the Pallas kernel (interpret mode) on
    inputs made by the port's own one-pass input preparation, after a cold
    step, so the batch has hit, miss, skip, fallback and no-endpoint
    lanes.  The port's batch is ragged; the JAX kernel takes 128 lanes."""
    cluster, services, _, _, tcps, tsvc = world
    step, state, (drs, dsvc) = tpl.make_pipeline(tcps, tsvc, device="cpu",
                                                 **KW)
    meta = step.meta
    fwd = [_t(a) for a in _traffic(cluster, services, seed=3)]
    state, _ = step(state, drs, dsvc, *fwd, 100, 0)
    lanes = [torch.cat([a[:B // 2], b[B // 2:]]) for a, b in zip(
        fwd, (_t(a) for a in _traffic(cluster, services, seed=5)))]
    src_f, dst_f, proto, sport, dport = lanes
    now, gen_w = 101, 0
    n = meta.flow_slots
    pp = tpl._pair16(sport, dport)
    h = thash.flow_hash(tpl._raw_bits(src_f), tpl._raw_bits(dst_f), proto,
                        sport, dport)
    slot = h & (n - 1)
    pg_cur = proto | 0x100 | (gen_w << 9)
    pg_est = proto | 0x100 | (tpl.GEN_ETERNAL << 9)
    hit, _, _, mr, kr0, ts0 = tpl._cache_lookup(
        state.flow, slot, torch.stack([src_f, dst_f], 1), pp, pg_cur, pg_est,
        now, proto, meta)
    x, _ = tpl._onepass_inputs(state.aff, drs, dsvc, src_f, dst_f, proto,
                               sport, dport, pp, h, ~hit, kr0, mr, ts0, now,
                               meta)
    ing, eg = drs.ingress, drs.egress
    tabs = top.OnepassTables(
        inc=tuple(t.inc for t in (ing.at, ing.peer, ing.svc, eg.at, eg.peer,
                                  eg.svc)),
        act_in=ing.action, act_out=eg.action)
    mm = meta.match
    st = top.OnepassStatic(k=K, in_phases=mm.in_phases,
                           out_phases=mm.out_phases, svcref=mm.svcref,
                           timeouts=meta.timeouts, n_slots=n,
                           pref_mask=tpl.PREF_MASK)
    got = top.onepass(x, tabs, now, gen_w, st)

    def pad(t, u32=False):
        a = np.pad(t.numpy(), ((0, 128 - B), (0, 0)))
        return jnp.asarray(a.view(np.uint32) if u32 else a)

    s_in, s_out = x.agg[0].shape[1], x.agg[3].shape[1]
    call = jm._onepass_call(128, s_in, s_out, K, K, mm.in_phases,
                            mm.out_phases, mm.svcref, True, meta.timeouts, n,
                            tpl.PREF_MASK, True)
    scal = jnp.asarray([[now, gen_w, 0, 0]], jnp.int32)
    inc2 = [jnp.asarray(t.numpy().view(np.uint32).reshape(-1, 32))
            for t in tabs.inc]
    want = call(pad(x.pkt), pad(x.kr), pad(x.prb), pad(x.mrow), pad(x.msk),
                pad(x.lb), *(pad(a, u32=True) for a in x.agg), pad(x.iv),
                scal, *inc2, jnp.asarray(ing.action.numpy()),
                jnp.asarray(eg.action.numpy()))
    for name, g, w in zip(("main", "keys8", "meta8", "aux"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:B],
                                      err_msg=name)
    main, aux = got[0].numpy(), got[3].numpy()
    assert main[:, 11].any() and not main[:, 11].all()  # hit and miss lanes
    assert aux[:, 0].any() and aux[:, 1].any()  # skip and fallback lanes
    assert (main[:, 0] == 2).any()  # no-endpoint REJECT lanes
