"""The port's phase profiler (antrea_tpu_torch/models/profile.py) against
the JAX package's, on the CPU: the same chains, the same result keys (plus
the device name), phases that sum to the total, and the caller's state left
as it was.  Timings on the CPU are noise; only the structure is checked.

The JAX profilers run with their device_loop_time replaced by a constant, so
they warm their state (two compiled steps) and build the same dict without
compiling a timing loop."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antrea_tpu.compiler.compile import compile_policy_set
from antrea_tpu.compiler.services import compile_services
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.models import profile as jprof
from antrea_tpu.simulator import gen_cluster, gen_services, gen_traffic
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.compiler.compile import compile_policy_set as t_compile
from antrea_tpu_torch.compiler.services import \
    compile_services as t_compile_services
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.models import profile as tprof
from antrea_tpu_torch.simulator import gen_cluster as t_gen_cluster
from antrea_tpu_torch.simulator import gen_services as t_gen_services
from antrea_tpu_torch.simulator import gen_traffic as t_gen_traffic
from antrea_tpu_torch.utils import ip as t_iputil
import torch_cpu  # noqa: F401  (one torch thread a worker)

CHAINS = ("PHASE_CHAIN", "ASYNC_PHASE_CHAIN", "OVERLAP_PHASE_CHAIN",
          "MAINT_PHASE_CHAIN", "PRUNE_PHASE_CHAIN", "FUSED_PHASE_CHAIN")
PROFILES = ("profile_churn", "profile_churn_async", "profile_churn_overlap",
            "profile_churn_maintenance", "profile_churn_prune",
            "profile_churn_fused")
KW = dict(flow_slots=1 << 10, aff_slots=1 << 6, fused=True, prune_budget=2)
B, N_NEW, POOL = 64, 8, 256
# Tiny loops: structure, not timing.
LOOP = dict(n_new=N_NEW, k_small=1, k_big=2, repeats=1)


def _cols(tr, ip, mk):
    return tuple(mk(c) for c in (ip.flip_u32(tr.src_ip),
                                 ip.flip_u32(tr.dst_ip),
                                 tr.proto.astype(np.int32),
                                 tr.src_port.astype(np.int32),
                                 tr.dst_port.astype(np.int32)))


@pytest.fixture(scope="module")
def twins():
    """One small world in both packages (a one-pass meta, K = 2: every
    profiler accepts it): (JAX args, port args) for profile_*(meta, state,
    drs, dsvc, hot, pool)."""
    kw = dict(n_nodes=4, pods_per_node=8, seed=2)

    def args(gc, gs, gt, comp, comp_svc, mp, ip, mk):
        cluster = gc(300, **kw)
        services = gs(8, cluster.pod_ips, seed=3)
        step, state, (drs, dsvc) = mp(comp(cluster.ps), comp_svc(services),
                                      **KW)
        hot = _cols(gt(cluster.pod_ips, B, n_flows=48, seed=3,
                       services=services), ip, mk)
        pool = _cols(gt(cluster.pod_ips, POOL, n_flows=POOL, seed=7,
                        one_per_flow=True), ip, mk)
        return step.meta, state, drs, dsvc, hot, pool

    j = args(gen_cluster, gen_services, gen_traffic, compile_policy_set,
             compile_services, jpl.make_pipeline, iputil, jnp.asarray)
    t = args(t_gen_cluster, t_gen_services, t_gen_traffic, t_compile,
             t_compile_services,
             lambda c, s, **k: tpl.make_pipeline(c, s, device="cpu", **k),
             t_iputil, lambda c: torch.from_numpy(
                 np.ascontiguousarray(c, dtype=np.int32)))
    assert j[0].onepass and t[0].onepass
    return j, t


@pytest.mark.parametrize("name", CHAINS)
def test_chains_equal_reference(name):
    assert getattr(tprof, name) == getattr(jprof, name)


@pytest.mark.parametrize("name", PROFILES)
def test_profile_matches_reference_structure(twins, name, monkeypatch):
    j, t = twins
    monkeypatch.setattr(jprof, "device_loop_time", lambda *a, **k: 1e-3)
    want = getattr(jprof, name)(*j, n_new=N_NEW)
    before = tpl.clone_state(t[1])
    got = getattr(tprof, name)(*t, **LOOP)
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    chain = dict(profile_churn=tprof.PHASE_CHAIN,
                 profile_churn_async=tprof.ASYNC_PHASE_CHAIN,
                 profile_churn_overlap=tprof.OVERLAP_PHASE_CHAIN,
                 profile_churn_maintenance=tprof.MAINT_PHASE_CHAIN,
                 profile_churn_prune=tprof.PRUNE_PHASE_CHAIN,
                 profile_churn_fused=tprof.FUSED_PHASE_CHAIN)[name]
    assert list(got["phases_s"]) == [n for n, _ in chain]
    assert list(got["phases_s"]) == list(want["phases_s"])
    assert got["total_s"] == got["cumulative_s"][chain[-1][0]]
    assert abs(sum(got["phases_s"].values()) - got["total_s"]) < 1e-12
    assert got["total_s"] > 0 and got["pps"] > 0
    assert (got["batch"], got["fresh_per_step"]) == (B, N_NEW)
    for a, b in zip((*before.flow, *before.aff), (*t[1].flow, *t[1].aff)):
        assert torch.equal(a, b)  # the caller's state is untouched


def test_profile_refusals(twins):
    _, (meta, state, drs, dsvc, hot, pool) = twins
    with pytest.raises(ValueError, match="pool"):
        tprof.profile_churn_async(meta, state, drs, dsvc, hot, None)
    with pytest.raises(ValueError, match="one-pass"):
        tprof.profile_churn_fused(meta._replace(onepass=False), state, drs,
                                  dsvc, hot, pool)
    with pytest.raises(ValueError, match="prune_budget"):
        tprof.profile_churn_prune(
            meta._replace(match=meta.match._replace(prune_budget=0)), state,
            drs, dsvc, hot, pool)
