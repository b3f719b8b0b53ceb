"""The port's cold-path study against the JAX package's, on the CPU.

S1's plain version (ops/consumer2.and_hits_plain) is held bit for bit to the
study's Pallas kernel `consumer2`, rebuilt here from bench_cold_study.py
(that script parses its arguments at import) and run in interpret mode, on
phase boundaries inside a word, empty phases and a baseline phase that
starts in the last word.  bench_cold_study_torch.py's smoke run (cases 4-6,
in a subprocess) must report, for every K and density of case 6, exactly the
fallback and skip rates of the JAX package's classify_batch on the same
world.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antrea_tpu.compiler.compile import compile_policy_set
from antrea_tpu.ops import match as jm
from antrea_tpu.simulator.genpolicy import gen_cluster
from antrea_tpu.simulator.traffic import gen_traffic
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch.ops import consumer2
import torch_cpu  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parent.parent


def _consumer2(b, w_in, w_out, in_phases, out_phases):
    """bench_cold_study.py:129-143, in interpret mode."""
    from jax.experimental import pallas as pl

    def kernel(mi, mo, o_ref):
        i0, ik, ib = jm._phase_scan_tile(mi[:], w_in, in_phases)
        o0, ok_, ob = jm._phase_scan_tile(mo[:], w_out, out_phases)
        o_ref[:] = jnp.stack([i0, ik, ib, o0, ok_, ob,
                              jnp.zeros_like(i0), jnp.zeros_like(i0)], axis=1)

    tb = jm._FUSE_TB
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b, 8), jnp.int32),
        grid=(b // tb,),
        in_specs=[pl.BlockSpec((tb, w), lambda i: (i, 0))
                  for w in (w_in, w_out)],
        out_specs=pl.BlockSpec((tb, 8), lambda i: (i, 0)),
        interpret=True,
    )


@pytest.mark.parametrize("w_in,w_out,in_ph,out_ph", [
    # Every phase boundary inside a word.
    (5, 3, (37, 50, 73), (20, 33, 43)),
    # No phase-0 rules (n0 = 0), and no K8s rules (nk = 0).
    (4, 4, (0, 70, 58), (40, 0, 88)),
    # The baseline phase starts in the last word.
    (4, 2, (60, 40, 28), (33, 30, 1)),
], ids=["in-word", "empty-phases", "baseline-last-word"])
def test_plain_consumer2_equals_pallas(w_in, w_out, in_ph, out_ph):
    b = 256
    rng = np.random.default_rng(w_in * 10 + w_out)

    def mat(w):
        bits = rng.random((b, w, 32)) < 0.04
        words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)
                 ).sum(axis=2).astype(np.uint32)
        words[::7] = 0  # lanes with no match
        return words.view(np.int32)

    mi, mo = mat(w_in), mat(w_out)
    want = np.asarray(_consumer2(b, w_in, w_out, in_ph, out_ph)(
        jnp.asarray(mi), jnp.asarray(mo)))
    before = consumer2.launches
    got = consumer2.and_hits(torch.from_numpy(mi), torch.from_numpy(mo),
                             in_ph, out_ph)
    assert consumer2.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        consumer2.and_hits_plain(torch.from_numpy(mi), torch.from_numpy(mo),
                                 in_ph, out_ph).numpy(), want)
    spans = [span for (n0, nk, _), w in ((in_ph, w_in), (out_ph, w_out))
             for span in ((0, n0), (n0, n0 + nk), (n0 + nk, w * 32))]
    for col, (lo, hi) in enumerate(spans):
        hits = want[:, col] < jm.BIG
        if lo < hi:  # lanes with and without a hit
            assert hits.any() and not hits.all(), col
        else:  # an empty phase never hits
            assert not hits.any(), col


def test_and_hits_checks_its_inputs():
    m = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        consumer2.and_hits(m.long(), m, (1, 1, 1), (1, 1, 1))
    with pytest.raises(ValueError):
        consumer2.and_hits(m, torch.zeros((5, 3), dtype=torch.int32),
                           (1, 1, 1), (1, 1, 1))
    with pytest.raises(ValueError):
        consumer2.and_hits(m.t(), m.t(), (1, 1, 1), (1, 1, 1))


def _jax_rates(drs, meta, src, dst, proto, dport):
    cls = jax.device_get(jm.classify_batch(drs, src, dst, proto, dport,
                                           meta=meta))
    return (float(np.asarray(cls["prune_fb"]).mean()),
            float(np.asarray(cls["prune_skip"]).mean()))


def test_study_smoke_rates_equal_reference(tmp_path):
    out = tmp_path / "study.json"
    # The child takes one torch thread, as this process does (torch_cpu).
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "bench_cold_study_torch.py"), "--smoke",
         "--device", "cpu", "--cases", "4,5,6", "--json", str(out)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    # The JAX side of the same smoke world while the port's run goes.
    B = 1 << 10
    cluster = gen_cluster(3_000, n_nodes=64, pods_per_node=32, seed=1)
    cps = compile_policy_set(cluster.ps)
    tr = gen_traffic(cluster.pod_ips, B, n_flows=B, seed=3)
    src = jnp.asarray(iputil.flip_u32(tr.src_ip))
    dst = jnp.asarray(iputil.flip_u32(tr.dst_ip))
    proto, dport = jnp.asarray(tr.proto), jnp.asarray(tr.dst_port)
    drs_p, meta_p1 = jm.to_device(cps, prune_budget=jm.PRUNE_LADDER[0])
    want_k = {str(k): _jax_rates(drs_p, meta_p1._replace(prune_budget=k),
                                 src, dst, proto, dport)
              for k in jm.PRUNE_LADDER}
    rng = np.random.default_rng(11)
    ext = rng.integers(1, 1 << 24, size=B).astype(np.uint32)
    want_d = {}
    for frac in (0.0, 0.5, 1.0):
        n_ext = int(B * frac)
        d_mix = np.asarray(tr.dst_ip).copy()
        s_mix = np.asarray(tr.src_ip).copy()
        d_mix[:n_ext] = ext[:n_ext]
        s_mix[:n_ext] = ext[::-1][:n_ext]
        want_d[str(frac)] = _jax_rates(
            drs_p, meta_p1._replace(prune_budget=4),
            jnp.asarray(iputil.flip_u32(s_mix)),
            jnp.asarray(iputil.flip_u32(d_mix)), proto, dport)

    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    assert "AND-in-torch + 2-input consumer (S1)" in stdout
    assert "overlap decomposition" in stdout
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["smoke"] and doc["batch"] == B
    assert set(doc["k_sweep"]) == set(want_k)
    for k, (fb, skip) in want_k.items():
        got = doc["k_sweep"][k]
        assert (got["fallback_rate"], got["skip_rate"]) == (fb, skip), k
    for frac, (fb, skip) in want_d.items():
        got = doc["density_sweep"][frac]
        assert (got["fallback_rate"], got["skip_rate"]) == (fb, skip), frac
    assert doc["density_sweep"]["1.0"]["skip_rate"] == 1.0
    assert any(v[0] > 0 for v in want_k.values())  # K = 1 falls back
