"""Package boundary of the PyTorch port: it imports neither jax nor the JAX
package, its entry points default to the card, and every knob it has not
ported refuses instead of taking another path."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antrea_tpu.models import pipeline as jpl
from antrea_tpu.ops import match as jm
from antrea_tpu_torch.compiler.compile import compile_policy_set
from antrea_tpu_torch.compiler.services import compile_services
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.simulator import gen_cluster, gen_services

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import antrea_tpu_torch
names = [m.name for m in pkgutil.walk_packages(antrea_tpu_torch.__path__,
                                               "antrea_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "antrea_tpu" or n.startswith("antrea_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "antrea_tpu"))


def test_import_loads_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert "antrea_tpu_torch.models.pipeline" in res["modules"]
    assert "antrea_tpu_torch.models.profile" in res["modules"]
    for mod in ("consumer", "pruned_consumer", "onepass", "consumer2"):
        assert f"antrea_tpu_torch.ops.{mod}" in res["modules"]
    assert res["bad"] == []


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "antrea_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_profile.py",
              ROOT / "bench_cold_study_torch.py"]
    seen = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            seen += [(f.name, n) for n in names if _forbidden(n)]
    assert len(files) > 20
    assert seen == []


@pytest.fixture(scope="module")
def tiny():
    cluster = gen_cluster(40, n_nodes=2, pods_per_node=4, seed=1)
    services = gen_services(4, cluster.pod_ips, seed=1)
    return compile_policy_set(cluster.ps), compile_services(services)


def test_entry_points_default_to_the_card(tiny, monkeypatch):
    cps, svc = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.make_pipeline(cps, svc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.make_classifier(cps)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.init_state(16, 16)
    step, state, (drs, _) = tpl.make_pipeline(cps, svc, flow_slots=16,
                                              aff_slots=16, device="cpu")
    assert state.flow.keys.device.type == "cpu"
    assert drs.ingress.at.inc.device.type == "cpu"


@pytest.mark.parametrize("knob", [
    {"dual_stack": True}, {"count_flow_stats": True},
    # The one-pass step's second-chance and telemetry branches.
    {"prune_budget": 4, "fused": True, "second_chance": True},
    {"second_chance": True},
    {"prune_budget": 4, "onepass": True, "telemetry": True},
    {"telemetry": True},
])
def test_unported_pipeline_knobs_raise(tiny, knob):
    cps, svc = tiny
    with pytest.raises(NotImplementedError):
        tpl.make_pipeline(cps, svc, device="cpu", **knob)


@pytest.mark.parametrize("knob", ["hit_combine", "valid", "no_commit", "v6"])
def test_unported_step_arguments_raise(tiny, knob):
    cps, svc = tiny
    step, state, (drs, dsvc) = tpl.make_pipeline(
        cps, svc, flow_slots=16, aff_slots=16, device="cpu")
    lanes = [torch.zeros(4, dtype=torch.int32)] * 5
    with pytest.raises(NotImplementedError, match=knob):
        tpl.pipeline_step(state, drs, dsvc, *lanes, 1, 0, meta=step.meta,
                          **{knob: object()})


@pytest.mark.parametrize("knob", [{"delta_slots": 8},
                                  # Delta patching under pruning.
                                  {"delta_slots": 1, "prune_budget": 2}])
def test_unported_table_knobs_raise(tiny, knob):
    with pytest.raises(NotImplementedError):
        tm.to_host(tiny[0], **knob)


def test_onepass_needs_the_aggregate_layer(tiny):
    """onepass=True over an unpruned world is refused as the JAX step
    refuses it; fused + prune_budget selects it, onepass=False pins the
    staged rounds."""
    cps, svc = tiny
    kw = dict(flow_slots=16, aff_slots=16, device="cpu")
    step, state, (drs, dsvc) = tpl.make_pipeline(cps, svc, onepass=True, **kw)
    lanes = [torch.zeros(4, dtype=torch.int32)] * 5
    with pytest.raises(ValueError, match="onepass"):
        step(state, drs, dsvc, *lanes, 1, 0)
    assert tpl.make_pipeline(cps, svc, fused=True, prune_budget=2,
                             **kw)[0].meta.onepass
    assert not tpl.make_pipeline(cps, svc, fused=True, prune_budget=2,
                                 onepass=False, **kw)[0].meta.onepass
    assert not tpl.make_pipeline(cps, svc, fused=True, **kw)[0].meta.onepass


def test_classify_summary_only_raises(tiny):
    """summary_only is ported (tests/test_torch_phases.py holds it to the
    JAX package): alone it runs, beside an unported knob it still raises."""
    drs, meta = tm.to_device(tiny[0], "cpu", prune_budget=2)
    lanes = [torch.zeros(4, dtype=torch.int32)] * 4
    out = tm.classify_batch(drs, *lanes, meta=meta, summary_only=True)
    assert not out["prune_fb"].any()
    with pytest.raises(NotImplementedError, match="v6"):
        tm.classify_batch(drs, *lanes, meta=meta, summary_only=True,
                          v6=object())


def test_constants_equal_reference():
    for name in ("MISS", "GEN_BITS", "GEN_ETERNAL", "REPLY_BIT", "PREF_MASK",
                 "CONF_BIT", "DSR_BIT", "REJECT_NONE", "REJECT_TCP_RST",
                 "REJECT_ICMP_UNREACH", "TCP_FIN", "TCP_RST", "PH_SLOW",
                 "PH_LB", "PH_CLS", "PH_COMMIT", "PH_EVICT", "PH_CLS_SUM",
                 "PH_ALL"):
        assert getattr(tpl, name) == getattr(jpl, name), name
    assert tm.BIG == jm.BIG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def test_bit_layout_helpers_equal_reference():
    rng = np.random.default_rng(3)
    n = 2048
    code = rng.integers(0, 4, n).astype(np.int32)
    svc = rng.integers(-1, 0x3FFE, n).astype(np.int32)
    port = rng.integers(0, 65536, n).astype(np.int32)
    rin = rng.integers(-1, 0xFFFD, n).astype(np.int32)
    rout = rng.integers(-1, 0xFFFD, n).astype(np.int32)
    m1 = jpl._pack_meta1(jnp.asarray(code), jnp.asarray(svc),
                         jnp.asarray(port))
    got = tpl._pack_meta1(_t(code), _t(svc), _t(port))
    np.testing.assert_array_equal(got.numpy(), np.asarray(m1))
    for a, b in zip(tpl._unpack_meta1(got), jpl._unpack_meta1(m1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rp = jpl._pack_rules(jnp.asarray(rin), jnp.asarray(rout))
    got = tpl._pack_rules(_t(rin), _t(rout))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rp))
    for a, b in zip(tpl._unpack_rules(got), jpl._unpack_rules(rp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # (sport << 16) | dport wraps into the sign bit in JAX's int32.
    pp = (jnp.asarray(port) << 16) | jnp.asarray(port[::-1].copy())
    got = tpl._pair16(_t(port), _t(port[::-1]))
    assert (np.asarray(pp) < 0).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(pp))
    f = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(tpl._raw_bits(_t(f)).numpy(),
                                  np.asarray(jpl._raw_bits(jnp.asarray(f))))
    proto = rng.choice([6, 17, 1], n).astype(np.int32)
    np.testing.assert_array_equal(
        tpl.reject_kind_of(_t(code), _t(proto)).numpy(),
        np.asarray(jpl.reject_kind_of(jnp.asarray(code), jnp.asarray(proto))))
    conf = rng.integers(0, 2, n).astype(np.int32)
    tmo = (10, 20, 30, 40)
    np.testing.assert_array_equal(
        tpl.entry_timeout(_t(conf), _t(proto), tmo).numpy(),
        np.asarray(jpl.entry_timeout(jnp.asarray(conf), jnp.asarray(proto),
                                     tmo)))


def test_winner_mask_equals_reference():
    rng = np.random.default_rng(5)
    slots = rng.integers(0, 64, 512).astype(np.int32)  # many duplicates
    mask = rng.random(512) < 0.7
    want = jpl._winner_mask(64, jnp.asarray(slots), jnp.asarray(mask), 64)
    got = tpl._winner_mask(64, torch.from_numpy(slots.astype(np.int64)),
                           torch.from_numpy(mask), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
