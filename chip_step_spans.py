#!/usr/bin/env python3
"""The engine's step spans on one CUDA card: their cost, the host time they
split, and the device's work and idle time by the span it falls under.

    python3 chip_step_spans.py [--workload one_ns_10k.conn_churn]
        [--seed N] [--seconds S] [--blocks K] [--block-steps N]

Builds the benchmark cell's world, traffic and engine as flowbench does
(flowbench/harness.py), steps its warm-up (every step's result observed by
the generator, as the benchmark's loop does, so that a Service mix's
replies come from the endpoints the engine chose), then:

  cost     K blocks of N steps, spans off and on in turn (no profiler):
           packets a second of each block, and the recorder's own
           bookkeeping a step, timed apart on the host;
  window   S seconds of steps with spans on and the benchmark's walk span
           (flowbench/trace.Spans, ended by a device synchronize), in the
           benchmark's loop: its engine_host_ms (step less walk) beside
           the sum of the host spans and engine.step's self time, the
           release of a step's result (after step() returns), timed
           alone, and the first read of both its rule-id fields, timed
           alone;
  profile  8 steps under torch.profiler, each inside the benchmark's
           flowbench.step range, as its traced stretch runs them: the
           benchmark's summary (flowbench/trace.summarize), then the
           device's idle time by the innermost program range open on the
           host, the device time of the work each span launched (by launch
           correlation), and the host-blocking CUDA calls a step by span;
  census   8 more steps under torch.profiler and the sync census
           (utils/sync_census) at once: the profiler's blocking calls a
           step beside the census's syncs.

Prints one JSON line and writes it to chiprun_out/step_spans.json."""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from antrea_tpu_torch.observability import tracing
from antrea_tpu_torch.utils.sync_census import SyncCensus
from flowbench import harness
from flowbench.stream import Stream
from flowbench.trace import Spans, _innermost, _union, summarize
from flowbench.world import build_world, plain_world

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "step_spans.json"
NAMES = [n for n, _ in tracing.STEP_SPANS]
PARENT = dict(tracing.STEP_SPANS)
HOST_SPANS = ("engine.upload", "engine.readback", "engine.rule_ids",
              "engine.account", "engine.result")
PROFILED = 8
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _program(name: str) -> bool:
    return name in PARENT or name.startswith("flowbench.")


def _under(name: str, root: str) -> bool:
    """name is root or a span below it (flowbench.walk sits in
    engine.walk)."""
    if name == "flowbench.walk":
        name = "engine.walk"
    while name is not None:
        if name == root:
            return True
        name = PARENT.get(name)
    return False


class _At:
    """Innermost program range at a host time, from _innermost's
    segments."""

    def __init__(self, segs):
        self.starts = [s for s, _, _ in segs]
        self.segs = segs

    def __call__(self, t):
        i = int(np.searchsorted(self.starts, t, side="right")) - 1
        if i >= 0 and self.segs[i][0] <= t < self.segs[i][1]:
            return self.segs[i][2]
        return "(none)"


def analyse(prof, steps: int) -> dict:
    """A profile of `steps` engine steps -> idle seconds by innermost
    program range, device seconds by the innermost program range its
    launch ran in, blocking calls a step by innermost program range."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == cuda:
            if getattr(ev, "is_user_annotation", False) or _program(ev.name):
                continue
            dev.append((tr.start, tr.end, ev.name, ev.id))
        else:
            host.append((tr.start, tr.end, ev.name, ev.thread, ev.id))
    stepping = {h[3] for h in host if h[2] == "flowbench.step"}
    host = [h for h in host if h[3] in stepping]
    # Innermost with the benchmark's ranges (idle, as its summary names
    # it) and without them (the program's own layers).
    at = _At(_innermost([h[:3] for h in host if _program(h[2])]))
    at_prog = _At(_innermost([h[:3] for h in host if h[2] in PARENT]))
    lo = min([h[0] for h in host] + [d[0] for d in dev])
    hi = max([h[1] for h in host] + [d[1] for d in dev])
    busy = _union([(s, e) for s, e, _, _ in dev])
    gaps = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                 for i in range(len(busy) - 1)]
    gaps.append((busy[-1][1], hi))
    idle = defaultdict(float)
    segs = at.segs
    for gs, ge in gaps:
        covered = 0.0
        for s, e, n in segs:
            o = min(ge, e) - max(gs, s)
            if o > 0:
                idle[n] += o * 1e-6
                covered += o
        if ge - gs > covered:
            idle["(none)"] += (ge - gs - covered) * 1e-6
    # Launch correlation: a device op's id is its runtime call's.
    runtime = {h[4]: h for h in host if h[2].startswith("cu")}
    dev_by = defaultdict(float)
    matched = 0
    for s, e, n, cid in dev:
        call = runtime.get(cid)
        if call is None:
            dev_by["(unmatched)"] += (e - s) * 1e-6
            continue
        matched += 1
        dev_by[at_prog(call[0])] += (e - s) * 1e-6
    # Blocking points: a sync call, or a device-to-host or pageable copy
    # not followed by a sync call (then the sync is the same point).  The
    # benchmark's own is its walk span's device synchronize.
    dev_name = {cid: n for _, _, n, cid in dev}
    calls = sorted((h for h in host if h[2].startswith("cuda")),
                   key=lambda h: h[0])
    syncs = defaultdict(int)
    names = defaultdict(int)
    for i, (s, e, n, _, cid) in enumerate(calls):
        if n in SYNC_CALLS:
            blocking = True
        elif n.startswith("cudaMemcpy"):
            d = dev_name.get(cid, "")
            nxt = calls[i + 1][2] if i + 1 < len(calls) else ""
            blocking = (("DtoH" in d or "Pageable" in d or n == "cudaMemcpy")
                        and nxt not in SYNC_CALLS)
        else:
            blocking = False
        if blocking:
            own = n == "cudaDeviceSynchronize" and at(s) == "flowbench.walk"
            syncs["(flowbench.walk's own)" if own else at_prog(s)] += 1
            names[n] += 1
    in_engine = sum(v for k, v in idle.items() if _under(k, "engine.step"))
    return {
        "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_under_engine_step_s": in_engine,
        "idle_engine_step_self_share": (idle.get("engine.step", 0.0)
                                        / in_engine if in_engine else None),
        "device_s_by_span": dict(sorted(dev_by.items(),
                                        key=lambda kv: -kv[1])),
        "device_ops": len(dev), "device_ops_matched": matched,
        "commit_device_ms": dev_by.get("walk.commit", 0.0) / steps * 1e3,
        "syncs_by_span": {k: v / steps for k, v in syncs.items()},
        "syncs_per_step": sum(v for k, v in syncs.items()
                              if k in PARENT) / steps,
        "blocking_calls": dict(names),
    }


def step(eng, stream, t: int):
    """Step t of the cell's stream, its result observed."""
    r = eng.step(stream.batch(t), stream.now(t))
    stream.observe(t, r)
    return r


def bookkeeping_us(n: int = 20000) -> float:
    """Host microseconds of one step's span bookkeeping, spans nested as
    the engine's step nests them, no profiler and no work between."""
    rec = tracing.StepSpans(4096)
    kids = [x for x in NAMES[1:] if PARENT[x] == "engine.step"]
    t0 = time.perf_counter()
    for _ in range(n):
        rec.begin(time.perf_counter_ns())
        for k in kids:
            rec.enter(k)
            if k == "engine.walk":
                for w in ("walk.probe", "walk.classify", "walk.commit"):
                    rec.enter(w)
                    if w == "walk.classify":
                        rec.enter("walk.lb")
                        rec.leave()
                    rec.leave()
            rec.leave()
        rec.end(time.perf_counter_ns())
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="one_ns_10k.conn_churn")
    ap.add_argument("--seed", type=int, default=2**31 + 77)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--block-steps", type=int, default=100)
    a = ap.parse_args()
    spec = harness.cell_spec(harness.load_bench(ROOT), a.workload, ROOT)
    world = build_world(spec["config"])
    stream = Stream(spec["mix"], plain_world(world), a.seed)
    eng = harness.build_engine(world, "cuda")
    sync = torch.cuda.synchronize
    t = 0
    for t in range(stream.warm_steps):
        step(eng, stream, t)
    t = stream.warm_steps
    sync()
    out = {"workload": a.workload, "seed": a.seed,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "batch": stream.batch_size}

    # cost: spans off and on in turn.
    rates = {"off": [], "on": []}
    for k in range(a.blocks):
        side = "on" if k % 2 else "off"
        if side == "on":
            eng.enable_step_spans(a.block_steps * len(NAMES))
        t0 = time.perf_counter()
        for _ in range(a.block_steps):
            step(eng, stream, t)
            t += 1
        dt = time.perf_counter() - t0
        eng.disable_step_spans()
        rates[side].append(a.block_steps * stream.batch_size / dt)
    off, on = statistics.median(rates["off"]), statistics.median(rates["on"])
    out["cost"] = {"pkts_per_s_off": rates["off"], "pkts_per_s_on": rates["on"],
                   "median_off": off, "median_on": on,
                   "on_over_off": on / off,
                   "bookkeeping_us_a_step": bookkeeping_us()}

    # window: spans on, the benchmark's walk span, its loop (rebinding r
    # releases the last step's result inside the timed call, as there).
    spans = Spans()
    lat = []
    rec = eng.enable_step_spans(1 << 16)
    with spans.installed(sync):
        end = time.perf_counter() + a.seconds
        r = None
        while True:
            b = stream.batch(t)
            s0 = time.perf_counter()
            r = eng.step(b, stream.now(t))
            s1 = time.perf_counter()
            lat.append(s1 - s0)
            stream.observe(t, r)
            t += 1
            if s1 >= end:
                break
        st = rec.stats()
        n = st["steps"]
        ms = {k: v["total_s"] / n * 1e3 for k, v in st["spans"].items()}
        self_ms = {k: v["self_s"] / n * 1e3 for k, v in st["spans"].items()}
        host = sum(ms[k] for k in HOST_SPANS) + self_ms["engine.step"]
        walk = np.mean(spans.walk_s) * 1e3
        eh = np.mean(lat) * 1e3 - walk
        # The release of a step's result, timed alone.
        rel = []
        for _ in range(40):
            new = step(eng, stream, t)
            t += 1
            d0 = time.perf_counter()
            r = new
            rel.append(time.perf_counter() - d0)
        # The first read of a step's attribution, as the benchmark's
        # check reads its sampled steps after the window (where a step
        # resolves its ids on read, this is where they are resolved).
        first = []
        for _ in range(20):
            r = step(eng, stream, t)
            t += 1
            d0 = time.perf_counter()
            r.ingress_rule, r.egress_rule
            first.append(time.perf_counter() - d0)
        del new, r
        out["window"] = {
            "steps": n, "dropped": st["dropped_total"],
            "step_ms": float(np.mean(lat) * 1e3),
            "walk_ms": float(walk),
            "engine_host_ms": float(eh), "spans_host_ms": host,
            "spans_over_engine_host": host / eh,
            "outside_root_ms": float(np.mean(lat) * 1e3 - ms["engine.step"]),
            "release_ms": float(np.mean(rel) * 1e3),
            "release_ms_median": float(np.median(rel) * 1e3),
            "first_read_ms": float(np.median(first) * 1e3),
            "span_ms": ms, "self_ms": self_ms}

        # profile: the benchmark's traced stretch, spans on.
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(PROFILED):
                with torch.profiler.record_function("flowbench.step"):
                    step(eng, stream, t + i)
            sync()
        t += PROFILED
        s = summarize(prof, PROFILED)
        out["profile"] = {"busy_s": s["busy_s"], "span_s": s["span_s"],
                          "launches_per_step": s["kernels"] / PROFILED,
                          "idle_gaps": s["idle_gaps"],
                          **analyse(prof, PROFILED)}

    # census: the profiler and the sync census on the same steps (no walk
    # span: its synchronize is the benchmark's, not the engine's).
    sync()
    with torch.profiler.profile(activities=acts) as prof, \
            SyncCensus() as census:
        for i in range(PROFILED):
            with torch.profiler.record_function("flowbench.step"):
                step(eng, stream, t + i)
        sync()
    c = analyse(prof, PROFILED)
    out["census"] = {
        "profiler_syncs_per_step": c["syncs_per_step"],
        "profiler_syncs_by_span": c["syncs_by_span"],
        "blocking_calls": c["blocking_calls"],
        "census_syncs_per_step": census.total / PROFILED,
        "census_lines": {f"{p}:{k}:{n}": v / PROFILED
                         for (p, k, n), v in census.lines.items()},
        "census_unattributed": census.unattributed}
    eng.disable_step_spans()
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
