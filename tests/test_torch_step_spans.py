"""The engine's step spans (observability/tracing.StepSpans), on the CPU:
spans change no result; with spans on every step yields each STEP_SPANS
name once, nested as the table says; the ring is bounded and meters its
drops; the profiler's ranges open under torch.profiler and at no other
time; and every span name has a site in the source and every site a
name."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread a worker)
from antrea_tpu_torch.datapath import TpuflowDatapath
from antrea_tpu_torch.observability import tracing
from antrea_tpu_torch.packet import PacketBatch
from antrea_tpu_torch.simulator import gen_cluster, gen_traffic

PKG = Path(tracing.__file__).resolve().parents[1]
NAMES = [n for n, _ in tracing.STEP_SPANS]
PARENT = dict(tracing.STEP_SPANS)


@pytest.fixture(scope="module")
def cluster():
    return gen_cluster(40, n_nodes=2, pods_per_node=8, seed=3)


def _engine(cluster):
    # A one-pass engine whose 64-slot cache every 128-lane batch overflows.
    return TpuflowDatapath(cluster.ps, [], device="cpu", fused=True,
                           prune_budget=2, flow_slots=1 << 6,
                           aff_slots=1 << 4, miss_chunk=64, canary_probes=0)


def _batches(cluster, n=4):
    """Fresh flows each step, then the first step's again (hits)."""
    out = []
    for seed in list(range(10, 10 + n)) + [10]:
        tr = gen_traffic(cluster.pod_ips, 128, n_flows=96, seed=seed)
        out.append(PacketBatch(src_ip=tr.src_ip, dst_ip=tr.dst_ip,
                               proto=tr.proto, src_port=tr.src_port,
                               dst_port=tr.dst_port))
    return out


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _leaves(eng):
    st = eng._state
    return [getattr(part, f) for part in (st.flow, st.aff)
            for f in part._fields]


def test_spans_change_no_result(cluster):
    off, on = _engine(cluster), _engine(cluster)
    rec = on.enable_step_spans(64)
    for t, b in enumerate(_batches(cluster)):
        _same(off.step(b, 100 + t), on.step(b, 100 + t))
        assert tracing.SLOT.sp is None
    assert off.cache_stats() == on.cache_stats()
    assert on.cache_stats()["evictions"] > 0
    for x, y in zip(_leaves(off), _leaves(on)):
        assert torch.equal(x, y)
    assert off.disable_step_spans() is None
    assert on.disable_step_spans() is rec and rec.steps == 5
    on.step(_batches(cluster, 1)[0], 200)
    assert rec.steps == 5 and on.disable_step_spans() is None


def test_each_step_yields_each_span_once_nested(cluster):
    eng = _engine(cluster)
    rec = eng.enable_step_spans(256)
    batches = _batches(cluster)
    for t, b in enumerate(batches[:4]):
        assert eng.step(b, 100 + t).n_miss > 0
    by_step = {}
    for seq, name, parent, t0, t1 in rec.records():
        by_step.setdefault(seq, {})
        assert name not in by_step[seq]
        by_step[seq][name] = (parent, t0, t1)
    assert sorted(by_step) == [1, 2, 3, 4]
    for spans in by_step.values():
        assert sorted(spans) == sorted(NAMES)
        for name, (parent, t0, t1) in spans.items():
            assert parent == PARENT[name] and t0 <= t1
            if parent is not None:
                _, p0, p1 = spans[parent]
                assert p0 <= t0 and t1 <= p1
    st = rec.stats()
    assert st["steps"] == 4 and st["dropped_total"] == 0
    for name, s in st["spans"].items():
        assert s["count"] == 4 and 0 <= s["self_s"] <= s["total_s"]
    kids = sum(st["spans"][n]["total_s"] for n in NAMES
               if PARENT[n] == "engine.step")
    root = st["spans"]["engine.step"]
    assert root["self_s"] == pytest.approx(root["total_s"] - kids, abs=1e-9)


def test_ring_is_bounded_and_meters_drops():
    with pytest.raises(ValueError):
        tracing.StepSpans(0)
    rec = tracing.StepSpans(5)
    for step in range(3):
        rec.begin(10 * step)
        rec.enter("engine.upload")
        rec.leave()
        rec.enter("engine.walk")
        rec.enter("walk.probe")  # left open: end() closes it
        rec.end(10 * step + 9)
    rs = rec.records()
    assert len(rs) == 5 and rec.dropped_total == 12 - 5
    assert [r[1] for r in rs[-3:]] == ["walk.probe", "engine.walk",
                                      "engine.step"]
    assert rs[-1] == (3, "engine.step", None, 20, 29)
    assert rec.stats()["spans"]["walk.probe"]["count"] == 3


def test_ranges_only_under_a_profiler(cluster, monkeypatch):
    on, off = _engine(cluster), _engine(cluster)
    on.enable_step_spans(64)
    b = _batches(cluster, 1)[0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on.step(b, 100)
        off.step(b, 100)
    names = [e.name for e in prof.events()]
    for n in NAMES:
        # The engine with spans on and the one with spans off.
        assert names.count(n) == 2, n
    assert off._step_spans is None and tracing.SLOT.sp is None

    def no_range(*a, **kw):
        raise AssertionError("a range opened outside a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    on.step(b, 101)
    off.step(b, 101)


def _sites() -> set:
    """The names the package's sources open spans under: sp.enter("...")
    and the recorder's own _open("...")."""
    out = set()
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("enter", "_open") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.add(node.args[0].value)
    return out


def test_every_span_name_has_a_site_and_every_site_a_name():
    assert len(set(NAMES)) == len(NAMES)
    assert _sites() == set(NAMES)
    assert all(p is None or p in PARENT for p in PARENT.values())
