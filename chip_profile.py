#!/usr/bin/env python3
"""Where the port's main-path step spends its time on the card.

    python3 chip_profile.py

Builds the 100k-rule world of chip_smoke.py and its two pipelines
(flow_slots=2**22, miss_chunk=256, fused=True: the staged step, and the
one-pass step with prune_budget=4, ct_timeout_s=3600) on one CUDA card, then
measures three windows, first without and then under torch.profiler:

  cold     a 4096-lane sub-batch on a fresh state through the staged step:
           16 miss rounds of 256;
  steady   two consecutive staged steps of the 2**17-lane batch after a cold
           and a warm step (the warm cache's collision misses alternate
           between two counts from step to step, so every window holds one
           of each);
  onepass  one one-pass step of the 2**17-lane batch that finds the whole
           cache expired (now 7200 s past the last step: every lane a miss).

For each window it prints the wall time (host clock around the work,
ending in torch.cuda.synchronize()), the device busy time (the sum of the
kernels' own device times in the profile), the device idle share, the
number of device launches (kernels, copies and fills) and of eager ops
(operators not nested in another), both counted in the exported trace,
the device time of torch's row gathers (aten::index), the
operators with the most device time, and each hand-written kernel's
launches and device time.
Chrome traces go to OUT_DIR.

Then two phase breakdowns (models/profile.py, telescoped differences over
cumulative phase masks, k_small=K_SMALL, k_big=K_BIG, best of REPEATS), with
N_NEW = B/8 fresh flows a step from a 2**18-flow pool: profile_churn of
the staged fused step (PHASE_CHAIN: the synchronous step, fast path alone
first) and profile_churn_fused of the one-pass step (FUSED_PHASE_CHAIN:
the async cadence, a fast step and a coalesced drain).  These times count
the host's share of each step (see utils/timing.device_loop_time).
"""

from __future__ import annotations

import json
import os
import sys
import time

import chip_smoke as smoke

TOP = 15
OUT_DIR = "chiprun_out"
K_SMALL, K_BIG, REPEATS = 2, 8, 3
# Device kernel names of the hand-written kernels (csrc/*.cu).
KERNELS = {"B1": "consumer_kernel", "B2": "pruned_kernel",
           "B3": "onepass_kernel"}


def self_device_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def is_kernel(e) -> bool:
    """A device-side row of key_averages() (a kernel or a device memcpy/
    memset); the other rows are host operators, whose self device time
    repeats their kernels' time."""
    return str(e.device_type).endswith("CUDA")


def trace_counts(path) -> tuple[int, int]:
    """(device launches: kernels, copies and fills; eager ops: CPU
    operators not nested in another) of an exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = sum(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   for e in events)
    ops = sorted((e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "cpu_op")
    n_ops, end = 0, {}
    for tid, t0, t1 in ops:
        if t0 >= end.get(tid, float("-inf")):
            n_ops += 1
            end[tid] = t1
    return launches, n_ops


def window(name, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # the window's own warm-up run (fresh inputs each call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, f"profile_{name}.json")
    prof.export_chrome_trace(trace)
    n_launch, n_ops = trace_counts(trace)
    rows = sorted(prof.key_averages(), key=self_device_us, reverse=True)
    kernels = [e for e in rows if is_kernel(e)]
    busy_us = sum(self_device_us(e) for e in kernels)
    index = [e for e in rows if e.key == "aten::index"]
    index_ms = sum(self_device_us(e) for e in index) / 1e3
    ours = {}
    for k, sym in KERNELS.items():
        rows_k = [e for e in kernels if sym in e.key]
        ours[k] = {"launches": sum(e.count for e in rows_k),
                   "ms": sum(self_device_us(e) for e in rows_k) / 1e3}
    print(f"[{name}] wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_us / 1e6 / wall):.3f}, {n_launch} device "
          f"launches, {n_ops} eager ops; aten::index "
          f"{sum(e.count for e in index)} calls {index_ms:.3f} ms; "
          + ", ".join(f"{k} {v['launches']} launches {v['ms']:.3f} ms"
                      for k, v in ours.items()), flush=True)
    top = []
    ops = [e for e in rows if not is_kernel(e) and self_device_us(e) > 0]
    for e in ops[:TOP]:
        us = self_device_us(e)
        top.append({"op": e.key, "device_ms": us / 1e3, "calls": e.count})
        print(f"  {us / 1e3:9.3f} ms  {e.count:7d}x  {e.key[:90]}")
    return {"window": name, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3, "device_launches": n_launch,
            "eager_ops": n_ops,
            "aten_index_ms": index_ms,
            "kernels": ours, "top": top}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from antrea_tpu_torch.models import pipeline as pl

    dev = torch.device("cuda")
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    cps, svc, tr, pool_tr = smoke.build_world()[:4]
    step, state, (drs, dsvc) = pl.make_pipeline(
        cps, svc, flow_slots=smoke.FLOW_SLOTS, miss_chunk=smoke.MISS_CHUNK,
        fused=True, device=dev)
    lanes = smoke.to_lanes(tr, dev)
    sub = smoke.to_lanes(tr, dev, smoke.CROSS_LANES)

    def cold():
        st = pl.init_state(smoke.FLOW_SLOTS, step.meta.aff_slots, device=dev)
        step(st, drs, dsvc, *sub, 100, 0)

    clock = iter(range(102, 10**6))
    state, _ = step(state, drs, dsvc, *lanes, 100, 0)
    state, _ = step(state, drs, dsvc, *lanes, 101, 0)

    def steady():
        for _ in range(2):
            step(state, drs, dsvc, *lanes, next(clock), 0)

    ostep, ostate, (pdrs, pdsvc) = pl.make_pipeline(
        cps, svc, flow_slots=smoke.FLOW_SLOTS, miss_chunk=smoke.MISS_CHUNK,
        fused=True, prune_budget=smoke.PRUNE_K, ct_timeout_s=3600,
        device=dev)
    ostep(ostate, pdrs, pdsvc, *lanes, 100, 0)
    expire = iter(range(7300, 10**9, 7200))

    def onepass():
        ostep(ostate, pdrs, pdsvc, *lanes, next(expire), 0)

    res = [window("cold", cold), window("steady", steady),
           window("onepass", onepass)]
    print(json.dumps({"card": card, "windows": res}), flush=True)
    del state, ostate
    torch.cuda.empty_cache()

    from antrea_tpu_torch.models import profile as prof

    pool = smoke.to_lanes(pool_tr, dev)
    kw = dict(n_new=smoke.B // 8, k_small=K_SMALL, k_big=K_BIG,
              repeats=REPEATS)
    breakdowns = []
    for name, fn, st, meta, tabs in (
            ("staged fused", prof.profile_churn, step, step.meta,
             (drs, dsvc)),
            ("one-pass K=4", prof.profile_churn_fused, ostep, ostep.meta,
             (pdrs, pdsvc))):
        fresh = pl.init_state(smoke.FLOW_SLOTS, meta.aff_slots, device=dev)
        t0 = time.perf_counter()
        out = fn(meta, fresh, *tabs, lanes, pool, **kw)
        del fresh
        torch.cuda.empty_cache()
        out.update(name=name, card=card, wall_s=time.perf_counter() - t0,
                   **{k: kw[k] for k in ("k_small", "k_big", "repeats")})
        print(f"[breakdown {name}] total {out['total_s'] * 1e3:.3f} ms/step "
              f"({out['pps'] / 1e6:.3f} M packets/s), on {out['device']}",
              flush=True)
        for ph, sec in out["phases_s"].items():
            print(f"  {ph:24s} {sec * 1e3:9.3f} ms  "
                  f"{out['phase_fractions'][ph]:7.3f}", flush=True)
        breakdowns.append(out)
    print(json.dumps({"card": card, "breakdowns": breakdowns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
