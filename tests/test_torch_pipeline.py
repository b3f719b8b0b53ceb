"""The PyTorch port's pipeline step against the JAX package, on the CPU.

Both steps get identical tables and initial state (the port's through
ruleset_from_numpy / services_from_numpy / state_from_numpy of the JAX
package's numpy output) and the same numpy-seeded batches.  After every
step every output key and every flow-cache and affinity column must be
equal, bit for bit, with the dump row excluded.
"""

import numpy as np
import pytest
import torch

import jax

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

B = 512
FLOW_SLOTS = 1 << 12
MISS_CHUNK = 128


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a),
                                                 dtype=np.int32))


def _lanes(tr):
    return (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip),
            tr.proto.astype(np.int32), tr.src_port.astype(np.int32),
            tr.dst_port.astype(np.int32))


@pytest.fixture(scope="module")
def world():
    cluster = gen_cluster(600, n_nodes=8, pods_per_node=8, seed=5)
    # seed 4: 15 affinity services and 3 without endpoints among 40.
    services = gen_services(40, cluster.pod_ips, affinity_fraction=0.3,
                            no_ep_fraction=0.1, seed=4)
    assert any(s.affinity_timeout_s > 0 for s in services)
    assert any(not s.endpoints for s in services)
    return cluster, services, compile_policy_set(cluster.ps), \
        compile_services(services)


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


@pytest.mark.parametrize("timeouts", [
    {},
    # Per-state lifetimes: half-open TCP entries expire before the
    # partner-refresh step and re-classify.
    {"ct_syn_timeout_s": 1000, "ct_other_new_s": 2500},
], ids=["uniform-timeouts", "per-state-timeouts"])
def test_pipeline_steps_equal_reference(world, timeouts):
    cluster, services, cps, svc = world
    kw = dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
              **timeouts)
    jstep, jstate, (jdrs, jdsvc) = jpl.make_pipeline(cps, svc, **kw)
    drs_np, _ = jm.to_host(cps)
    tdrs = tm.ruleset_from_numpy(drs_np, "cpu")
    tdsvc = tpl.services_from_numpy(jpl.svc_to_host(svc), "cpu")
    tstate = tpl.state_from_numpy(jax.device_get(jstate), "cpu")
    # The port's own world (its generators and compiler, same seeds) gives
    # the step's static shapes; the tables it runs on are the JAX ones.
    tcl = t_gen_cluster(600, n_nodes=8, pods_per_node=8, seed=5)
    tsvcs = t_gen_services(40, tcl.pod_ips, affinity_fraction=0.3,
                           no_ep_fraction=0.1, seed=4)
    tstep, _, _ = tpl.make_pipeline(t_compile(tcl.ps),
                                    t_compile_services(tsvcs),
                                    device="cpu", **kw)
    jmm = jstep.meta.match
    assert tstep.meta.match == tm.StaticMeta(
        jmm.in_phases, jmm.out_phases, jmm.w_in, jmm.w_out, jmm.svcref)

    base = gen_traffic(cluster.pod_ips, B, n_flows=256, seed=3,
                       services=services, svc_fraction=0.3)
    fwd = _lanes(base)
    assert (fwd[3] >= 32768).any()  # sport << 16 reaches the sign bit
    zero = np.zeros(B, np.int32)

    def run(lanes, now, gen=0, flags=None, what=""):
        nonlocal jstate, tstate
        jstate, jout = jpl.pipeline_step(
            jstate, jdrs, jdsvc, *lanes, now, gen, meta=jstep.meta,
            flags=zero if flags is None else flags)
        tstate, tout = tstep(tstate, tdrs, tdsvc, *(_t(a) for a in lanes),
                             now, gen,
                             flags=None if flags is None else _t(flags))
        _compare(jstate, jout, tstate, tout, what)
        return {k: v.numpy() for k, v in tout.items()}

    cold = run(fwd, 100, what="cold")
    assert cold["n_miss"] == B and cold["committed"].any()
    assert (cold["code"] == 2).any() and (cold["svc_idx"] >= 0).any()
    warm = run(fwd, 101, what="warm")
    assert warm["est"].any()
    # Past ct_timeout_s/2 since the commit stamp: established hits walk to
    # their partner entries and refresh them.
    run(fwd, 1902, what="partner refresh")
    zc = tstate.flow.meta[:-1, 3]
    assert ((zc & tpl.PREF_MASK) == 1902).any()

    # Reply-direction tuples of the committed flows: the first reply hit
    # CONFIRMs both directions.
    c = cold["committed"] == 1
    reply = (np.where(c, cold["dnat_ip_f"], fwd[0]),
             np.where(c, fwd[0], fwd[1]), fwd[2],
             np.where(c, cold["dnat_port"], fwd[3]),
             np.where(c, fwd[3], fwd[4]))
    rep = run(reply, 1903, what="reply/confirm")
    assert rep["reply"].any()
    assert ((tstate.flow.meta[:-1, 3] & tpl.CONF_BIT) != 0).any()

    # FIN on every other lane: established TCP entries are torn down in
    # both directions.
    fin = np.where(np.arange(B) % 2 == 0, tpl.TCP_FIN, 0).astype(np.int32)
    live = (tstate.flow.keys[:-1, 3] != 0).sum()
    run(fwd, 1904, flags=fin, what="teardown")
    assert (tstate.flow.keys[:-1, 3] != 0).sum() < live

    # A fresh batch with many new flows under a bumped generation: several
    # miss rounds, in-batch slot collisions and evictions.
    churn = _lanes(gen_traffic(cluster.pod_ips, B, n_flows=4096, seed=9,
                               services=services, svc_fraction=0.3))
    out = run(churn, 1905, gen=1, what="churn")
    assert out["n_miss"] > 2 * MISS_CHUNK and out["n_evict"] > 0

    # One client opening B new connections to one affinity service, after
    # every earlier learn has expired: every round's affinity lookup sees
    # the start-of-batch table (no lane hits a learn made earlier in the
    # same step), learns land in the live table.
    s = next(s for s in services
             if s.affinity_timeout_s > 0 and len(s.endpoints) > 1)
    one = np.ones(B, np.int64)
    aff_lanes = (
        iputil.flip_u32((one * cluster.pod_ips[0]).astype(np.uint32)),
        iputil.flip_u32((one * iputil.ip_to_u32(s.cluster_ip)).astype(
            np.uint32)),
        (one * s.protocol).astype(np.int32),
        (20000 + np.arange(B)).astype(np.int32),
        (one * s.port).astype(np.int32))
    out = run(aff_lanes, 2300, gen=1, what="affinity rounds")
    assert out["n_miss"] == B and len(np.unique(out["dnat_ip_f"])) > 1

