"""The port's phase-mask surface, async admission, drain reclaim,
summary-only classify and maintenance scans against the JAX package, on the
CPU.

Both steps get identical tables and initial state and the same numpy-seeded
batches, at the same meta (phases, miss_code, drain_reclaim, miss_chunk).
Every value is an int32 or u32 word: the tolerance is exact equality, and
after every step every output key and every flow-cache and affinity column
must be equal (the dump row excluded).  The staged steps classify unfused
(the fused kernels' plain versions have their own tests); the one-pass step
runs the JAX package's Pallas kernel in interpret mode, and only where
PH_CLS is set, as there.
"""

import numpy as np
import pytest
import torch

import jax

from antrea_tpu.compiler.compile import ACT_ALLOW, ACT_DROP
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
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.simulator import gen_cluster as t_gen_cluster
from antrea_tpu_torch.simulator import gen_services as t_gen_services
import torch_cpu  # noqa: F401  (one torch thread a worker)

B = 120
K = 2
# Half-open TCP entries expire after 50 s, so a step 100 s later meets
# idle-expired rows beside live ones.
KW = dict(flow_slots=1 << 8, aff_slots=1 << 6, miss_chunk=64,
          ct_syn_timeout_s=50)
# The seven distinct masks of models/profile's chains.
CHAIN_MASKS = (0, 1, 3, 35, 39, 47, 63)


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
    """tests/test_torch_onepass.py's world: 2500 rules on 64 pods (S_in = 2
    superblocks, so K = 2 prunes without falling back and the summary has
    candidates to count), affinity services and services without
    endpoints."""
    kw = dict(n_nodes=8, pods_per_node=8, seed=12)
    cluster = gen_cluster(2500, **kw)
    services = gen_services(40, cluster.pod_ips, affinity_fraction=0.3,
                            no_ep_fraction=0.1, seed=4)
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
    _compare_state(jstate, tstate, what)


def _compare_state(jstate, tstate, what):
    jstate = jax.device_get(jstate)
    for part in ("flow", "aff"):
        jt, tt = getattr(jstate, part), getattr(tstate, part)
        for f in jt._fields:
            want = np.asarray(getattr(jt, f))[:-1]  # dump row excluded
            got = getattr(tt, f).numpy()[:-1]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{what}: {part}.{f}")


def _twins(world, prune_budget=0, **knobs):
    """The JAX step and the port's step on the same tables and initial
    state.  -> (run(lanes, now, gen, what, **meta overrides) -> port out as
    numpy, the two states)."""
    cluster, services, cps, svc, tcps, tsvc = world
    kw = dict(KW, prune_budget=prune_budget, **knobs)
    jstep, jstate, (jdrs, jdsvc) = jpl.make_pipeline(cps, svc, **kw)
    drs_np, _ = jm.to_host(cps, prune_budget=prune_budget)
    tdrs = tm.ruleset_from_numpy(drs_np, "cpu")
    tdsvc = tpl.services_from_numpy(jpl.svc_to_host(svc), "cpu")
    tstate = tpl.state_from_numpy(jax.device_get(jstate), "cpu")
    tstep, _, _ = tpl.make_pipeline(tcps, tsvc, device="cpu", **kw)
    assert tstep.meta.onepass == jstep.meta.onepass
    st = {"j": jstate, "t": tstate}

    def run(lanes, now, gen=0, what="", **over):
        jmeta = jstep.meta._replace(**over)
        tmeta = tstep.meta._replace(**over)
        n = len(lanes[0])
        st["j"], jout = jpl.pipeline_step(
            st["j"], jdrs, jdsvc, *lanes, now, gen, meta=jmeta,
            flags=np.zeros(n, np.int32))
        st["t"], tout = tpl.pipeline_step(
            st["t"], tdrs, tdsvc, *(_t(a) for a in lanes), now, gen,
            meta=tmeta)
        _compare(st["j"], jout, st["t"], tout, what)
        return {k: v.numpy() for k, v in tout.items()}

    return run, st


def _churn(cluster, services):
    """Half the cold batch's flows and half new ones."""
    old = _traffic(cluster, services, seed=3)
    new = _traffic(cluster, services, seed=9, n_flows=4096)
    return tuple(np.concatenate([a[:B // 2], b[B // 2:]])
                 for a, b in zip(old, new))


@pytest.mark.parametrize("pruned", [False, True], ids=["unpruned", "pruned"])
@pytest.mark.parametrize("mask", CHAIN_MASKS)
def test_staged_phase_masks_equal_reference(world, mask, pruned):
    """A cold PH_ALL step, then a churn step (old and new flows, a bumped
    generation) at each chain mask, on the staged rounds (pruned: K = 2,
    onepass=False)."""
    cluster, services = world[:2]
    run, _ = _twins(world, prune_budget=K if pruned else 0, onepass=False)
    run(_traffic(cluster, services, seed=3), 100, what="cold")
    out = run(_churn(cluster, services), 101, gen=1, what=f"mask {mask}",
              phases=mask)
    assert out["n_miss"] > KW["miss_chunk"]  # several rounds
    if not mask & tpl.PH_SLOW:
        assert not out["committed"].any()


@pytest.mark.parametrize("mask", (0, 35, 39, 63))
def test_onepass_phase_masks_equal_reference(world, mask):
    cluster, services = world[:2]
    run, _ = _twins(world, prune_budget=K, onepass=True)
    run(_traffic(cluster, services, seed=3), 100, what="cold")
    out = run(_churn(cluster, services), 101, gen=1, what=f"mask {mask}",
              phases=mask)
    assert out["n_miss"] > 0
    if mask & tpl.PH_CLS_SUM:
        assert out["prune_cand_hist"][:-1].sum() == out["n_miss"]


@pytest.mark.parametrize("miss_code", [ACT_ALLOW, ACT_DROP],
                         ids=["allow", "drop"])
def test_async_fast_step_equals_reference(world, miss_code):
    """phases=0: misses keep the fast-path image with the admission
    verdict, nothing commits, and `miss` is the admission mask."""
    cluster, services = world[:2]
    run, _ = _twins(world)
    run(_traffic(cluster, services, seed=3), 100, what="cold")
    out = run(_churn(cluster, services), 101, what="fast", phases=0,
              miss_code=miss_code)
    miss = out["miss"] == 1
    assert miss.any() and not miss.all()
    assert (out["code"][miss] == miss_code).all()
    assert not out["committed"].any()


@pytest.mark.parametrize("onepass", [False, True],
                         ids=["staged", "onepass"])
def test_drain_reclaim_equals_reference(world, onepass):
    """The async cadence: a fast step at phases=0 with the DROP admission
    policy, then the coalesced drain of the admitted lanes (one round,
    drain_reclaim=True) over a cache holding idle-expired half-open rows
    and denials of the previous generation."""
    cluster, services = world[:2]
    run, st = _twins(world, prune_budget=K, onepass=onepass)
    run(_traffic(cluster, services, seed=3), 100, what="cold")
    churn = _churn(cluster, services)
    fast = run(churn, 200, gen=1, what="fast", phases=0, miss_code=ACT_DROP)
    adm = fast["miss"] == 1
    window = tuple(c[adm] for c in churn)
    out = run(window, 200, gen=1, what="drain", drain_reclaim=True,
              miss_chunk=int(adm.sum()))
    assert out["n_miss"] == adm.sum()
    assert out["n_reclaim"] > 0 and out["n_evict"] > 0


@pytest.mark.parametrize("svcref", [False, True], ids=["plain", "svcref"])
def test_summary_only_classify_equals_reference(world, svcref):
    """classify_batch(summary_only=True) over the pruned tables: the codes,
    rules and the three prune outputs bitwise."""
    cluster, services, cps, _, _, _ = world
    jdrs, jmeta = jm.to_device(cps, prune_budget=K)
    drs_np, _ = jm.to_host(cps, prune_budget=K)
    tdrs = tm.ruleset_from_numpy(drs_np, "cpu")
    tmeta = tm.StaticMeta(jmeta.in_phases, jmeta.out_phases, jmeta.w_in,
                          jmeta.w_out, svcref, K)
    jmeta = jmeta._replace(svcref=svcref)
    src, dst, proto, _, dport = _traffic(cluster, services, seed=3)
    ref = np.random.default_rng(7).integers(-1, 40, B).astype(np.int32)
    jout = jax.device_get(jm.classify_batch(
        jdrs, src, dst, proto, dport, meta=jmeta, summary_only=True,
        svc_ref=ref if svcref else None))
    tout = tm.classify_batch(tdrs, *(_t(a) for a in (src, dst, proto, dport)),
                             meta=tmeta, summary_only=True,
                             svc_ref=_t(ref) if svcref else None)
    assert set(tout) == set(jout)
    for k, v in jout.items():
        np.testing.assert_array_equal(tout[k].numpy().astype(np.int32),
                                      np.asarray(v).astype(np.int32),
                                      err_msg=k)
    assert tout["prune_cand"].any() and tout["prune_skip"].any()
    assert not tout["prune_fb"].any()


@pytest.fixture(scope="module")
def aged_state(world):
    """A cache after a cold step at gen 0: allows (ETERNAL), denials and
    half-open entries, as numpy (the JAX package's layout)."""
    cluster, services = world[:2]
    run, st = _twins(world)
    run(_traffic(cluster, services, seed=3), 100, what="cold")
    run(_churn(cluster, services), 101, what="churn")
    return jax.device_get(st["j"])


@pytest.mark.parametrize("scan", ["age", "revalidate", "maintain"])
def test_maintenance_scans_equal_reference(aged_state, scan):
    """At now = 200 (half-open rows expired) and gen = 1 (gen-0 denials
    stale): the counts and the cleared cache bitwise."""
    tmo = jpl.PipelineMeta(None, 1, 1, 3600, 1, ct_syn_timeout_s=50).timeouts
    jstate = jax.tree_util.tree_map(np.asarray, aged_state)
    tstate = tpl.state_from_numpy(aged_state, "cpu")
    if scan == "age":
        jstate, *jn = jpl.age_scan(jstate, 200, timeouts=tmo)
        tstate2, *tn = tpl._age_scan(tstate, 200, timeouts=tmo)
    elif scan == "revalidate":
        jstate, *jn = jpl.revalidate_scan(jstate, 1)
        tstate2, *tn = tpl._revalidate_scan(tstate, 1)
    else:
        jstate, *jn = jpl.maintain_scan(jstate, 200, 1, timeouts=tmo)
        tstate2, *tn = tpl._maintain_scan(tstate, 200, 1, timeouts=tmo)
    assert tstate2 is tstate  # in place
    assert [int(n) for n in tn] == [int(n) for n in jn]
    assert all(int(n) > 0 for n in tn)
    _compare_state(jstate, tstate, scan)
