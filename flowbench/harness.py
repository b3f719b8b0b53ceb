"""One run of one cell: the world and the engine from the seed (set-up),
the measured window of closed-loop steps, with --trace 1 the benchmark's
walk span over the window and a profiled stretch after it, then the check
of what the steps produced against the plain reference, and the result.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: BENCHMARK.json's entries name a configuration file (whose
`world` names its shape's module flowbench/worlds/<world>.py), a mix file
flowbench/traffic/<traffic>.json that the one generator
(flowbench/stream.py) reads, and, per metric, a reader
flowbench/metrics/<metric>.py.

The traffic is closed loop: after every step (warm-up, window, traced
stretch) the generator observes the result, and for a mix with Service
connections reads the code, dnat_ip and dnat_port of their first packets,
so that their replies come from the endpoint the program chose (a mix
without them observes nothing).  The check stays independent all the
same, since the reference decides the endpoint again: a program that
picks another endpoint fails `lanes_off` on the checked steps' first
packets, and then its replies come from an endpoint the reference never
committed, so the reference misses where the program hits and
`steps_miss_count_off` fails on every step that carries them; one that
reports one endpoint and caches another fails `lanes_off`."""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from collections import Counter
from contextlib import nullcontext
from pathlib import Path

import numpy as np

from .stream import Stream
from .world import build_world, load_config, plain_world, sub_seed

HERE = Path(__file__).resolve().parent
# Top-level module names no run may load: JAX and the JAX package (whose
# name the port's begins with; names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "antrea_tpu")
# Whole steps whose every lane the check compares (drawn from the seed
# over the window's steps), beside every step's miss count.
CHECKED_STEPS = 8
# Steps of the profiled stretch after the window (--trace 1).
TRACED_STEPS = 8


class CellError(Exception):
    """A run that cannot give a result (exit code 2)."""


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, workload: str, root: Path) -> dict:
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = load_config(root / cfgs[cell["config"]]["file"])
    mix = load_config(HERE / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m["name"] for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(cell=cell, config=cfg, mix=mix,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]),
                units={m["name"]: m["unit"] for m in
                       bench["end_to_end"] + bench["per_layer"]})


def reader(name: str):
    """flowbench/metrics/<name>.py's read(record) -> number or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"flowbench_metric_{len(name)}_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def build_engine(world, device):
    """The engine as the configuration's `engine` states it, every key
    passed on (one the engine does not take fails here)."""
    from antrea_tpu_torch.datapath import TpuflowDatapath

    return TpuflowDatapath(world.ps, world.services, device=device,
                           topology=world.topology, **world.config["engine"])


class Reservoir:
    """CHECKED_STEPS window steps drawn evenly from all of them, from the
    seed (reservoir sampling: the draw does not need the step count)."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng(sub_seed(seed, "check"))
        self.k, self.seen, self.kept = k, 0, {}

    def offer(self, t: int, result) -> None:
        if self.seen < self.k:
            self.kept[t] = result
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[t] = result
        self.seen += 1


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, engine_hook=None) -> dict:
    """-> the run's record: what the readers and the check read."""
    import torch

    cuda = device.startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    parts = {"imports": time.perf_counter() - t_start}
    c0 = time.perf_counter()
    world = build_world(cfg)
    parts["world"] = time.perf_counter() - c0
    # The plain copy of the inputs (the generator's and the reference's),
    # taken before the program holds them.
    c0 = time.perf_counter()
    plain = plain_world(world)
    stream = Stream(mix, plain, seed)
    parts["traffic"] = time.perf_counter() - c0
    c0 = time.perf_counter()
    eng = build_engine(world, device)
    sync()
    parts["engine"] = time.perf_counter() - c0
    if engine_hook is not None:
        engine_hook(eng)
    n_miss = []
    c0 = time.perf_counter()
    for t in range(stream.warm_steps):
        r = eng.step(stream.batch(t), stream.now(t))
        n_miss.append(r.n_miss)
        stream.observe(t, r)
    t = stream.warm_steps
    sync()
    parts["warm"] = time.perf_counter() - c0
    rec = dict(batch=stream.batch_size,
               setup_s=time.perf_counter() - t_start,
               first_window_step=t, setup_parts=parts, plain=plain)

    from .trace import KernelCalls, Spans
    spans, calls = Spans(), KernelCalls()
    res = Reservoir(seed, CHECKED_STEPS)
    lat = []
    pr0 = eng.prune_stats() or {}
    with spans.installed(sync) if trace else nullcontext(), \
            calls.installed() if trace else nullcontext():
        w0 = time.perf_counter()
        end = w0 + seconds
        while True:
            b = stream.batch(t)
            s0 = time.perf_counter()
            r = eng.step(b, stream.now(t))
            s1 = time.perf_counter()
            lat.append(s1 - s0)
            n_miss.append(r.n_miss)
            res.offer(t, r)
            stream.observe(t, r)
            t += 1
            if s1 >= end:
                break
        rec["window_s"] = s1 - w0
        rec["steps"] = len(lat)
        rec["lat_s"] = lat
        pr1 = eng.prune_stats() or {}
        rec["prune"] = {k: pr1.get(k, 0) - pr0.get(k, 0)
                        for k in ("fallbacks_total", "classified_total")}
        rec["walk_s"] = list(spans.walk_s)
        rec["n_miss_window"] = n_miss[rec["first_window_step"]:]
        if trace:
            rec["trace"] = _traced_stretch(eng, stream, t, calls, sync,
                                           n_miss)
            t += TRACED_STEPS
    rec["total_steps"] = t
    rec["n_miss"] = n_miss
    rec["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                if cuda else 0)
    rec["forbidden"] = forbidden_modules()
    rec["checked"] = res.kept
    rec["stream"] = stream
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def _traced_stretch(eng, stream, t, calls, sync, n_miss) -> dict:
    """TRACED_STEPS more steps under torch.profiler, the kernel calls'
    inputs captured -> the trace summary with the calls' rows-once bytes."""
    import torch

    from .roofline import b1_bytes, b3_bytes
    from .trace import summarize

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    calls.on = True
    with torch.profiler.profile(activities=acts) as prof:
        h0 = time.perf_counter()
        for i in range(TRACED_STEPS):
            with torch.profiler.record_function("flowbench.step"):
                r = eng.step(stream.batch(t + i), stream.now(t + i))
                n_miss.append(r.n_miss)
                stream.observe(t + i, r)
        sync()
        h1 = time.perf_counter()
    calls.on = False
    s = summarize(prof, TRACED_STEPS)
    s["host_s"] = h1 - h0
    s["b3_bytes"] = sum(
        b3_bytes(tabs.agg, tabs.bounds, tabs.iso_bounds, bool(st.svcref),
                 st.k, iv[main[:, 11] == 0], b)
        for tabs, st, main, iv, b in calls.b3)
    s["b3_calls"] = len(calls.b3)
    s["b1_bytes"] = sum(b1_bytes(tabs, iv, bool(svcref))
                        for tabs, iv, svcref in calls.b1)
    s["b1_calls"] = len(calls.b1)
    calls.b3.clear()
    calls.b1.clear()
    return s


# ---- the check ------------------------------------------------------------

def _program_columns(r, index: dict) -> dict:
    """A StepResult -> the reference's FIELDS as int64 columns, rule ids
    as the reference's rule numbers (-1 none, -2 a rule it does not
    know)."""
    from .reference.datapath import FIELDS

    out = {}
    for f in FIELDS:
        v = getattr(r, f)
        out[f] = (np.fromiter((-1 if x is None else index.get(x, -2)
                               for x in v), np.int64, count=len(v))
                  if f.endswith("_rule") else np.asarray(v).astype(np.int64))
    return out


def compare(rec: dict, device: str, replay=None) -> dict:
    """Replay every step of the run on the reference (`replay`: a
    reference.datapath.Replay, default the plain one) and compare: every
    step's miss count, and every lane of the sampled steps on every
    output field.  -> the numbers compared, each with its limit, and the
    field counts behind them."""
    from .reference.datapath import FIELDS, Replay

    ref = replay or Replay(rec["plain"], device)
    stream = rec["stream"]
    miss_off = lanes_off = lanes = allowed = replies = 0
    fields = Counter()
    for t in range(rec["total_steps"]):
        o = ref.step(ref.lanes(stream.columns(t)), stream.now(t),
                     t in rec["checked"])
        if o["n_miss"] != rec["n_miss"][t]:
            miss_off += 1
        if t in rec["checked"]:
            got = rec["checked"][t]
            if not isinstance(got, dict):
                got = _program_columns(got, ref.cls.index)
            off = np.zeros(len(o["code"]), bool)
            for f in FIELDS:
                d = got[f] != o[f]
                fields[f] += int(d.sum())
                off |= d
            lanes_off += int(off.sum())
            lanes += len(off)
            allowed += int((o["code"] == 0).sum())
            replies += int(o["reply"].sum())
    return {"checks": {"lanes_off": {"value": lanes_off, "limit": 0},
                       "steps_miss_count_off": {"value": miss_off,
                                                "limit": 0}},
            "fields_off": dict(fields), "lanes_checked": lanes,
            "allowed": allowed, "replies": replies,
            "steps_checked": rec["total_steps"]}


# ---- the command ----------------------------------------------------------

def main(argv, t_start: float, root: Path) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="flowbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        spec = cell_spec(load_bench(root), a.workload, root)
    except (CellError, OSError, KeyError, json.JSONDecodeError) as e:
        print(f"flowbench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"flowbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec = run_cell(spec["config"], spec["mix"], a.seed, a.seconds,
                   bool(a.trace), "cuda", t_start)
    if rec["forbidden"]:
        print(f"flowbench: the run loaded {rec['forbidden']}",
              file=sys.stderr)
        return 3
    return emit(rec, spec, bool(a.trace), "cuda", chips)


def result_line(rec: dict, spec: dict, trace: bool, device: str,
                chips: int, checked: dict) -> dict:
    import torch

    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for n in names:
        v = reader(n)(rec)
        if v is not None:
            metrics[n] = {"value": v, "unit": spec["units"][n]}
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in checked["checks"].values()),
            "attempted": rec["steps"] * rec["batch"], "failed": 0,
            "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr and "busy_s" in tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["span_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checked["checks"]
    return line


def emit(rec: dict, spec: dict, trace: bool, device: str, chips: int) -> int:
    c0 = time.perf_counter()
    checked = compare(rec, device)
    ref_s = time.perf_counter() - c0
    line = result_line(rec, spec, trace, device, chips, checked)
    bad = forbidden_modules()
    if bad:
        print(f"flowbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"flowbench: set-up {rec['setup_s']:.3f} s "
          f"({', '.join(f'{k} {v:.3f}' for k, v in rec['setup_parts'].items())}); "
          f"reference {ref_s:.3f} s", file=sys.stderr)
    print(f"flowbench: {rec['steps']} steps of {rec['batch']} lanes in "
          f"{rec['window_s']:.3f} s; checked {checked['lanes_checked']} "
          f"lanes of {len(rec['checked'])} steps and the miss count of "
          f"{checked['steps_checked']} steps; fields off "
          f"{checked['fields_off']}; of the checked lanes allowed "
          f"{checked['allowed']}, replies {checked['replies']}",
          file=sys.stderr)
    for n, c in checked["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0
