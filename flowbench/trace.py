"""The traced stretch: torch.profiler over a few steps after the measured
window, reduced in memory to what the per-layer readers need (nothing is
written to disk).  Also the two kernel-call captures of the roofline
readers and the benchmark's own span around the pipeline walk, each a
wrapper set on the program's module attribute for the traced run only."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

B3_KERNEL = "onepass_kernel"
B1_KERNEL = "consumer_kernel"


class Spans:
    """Host seconds of every call to models/forwarding.pipeline_step_full,
    each ended by torch.cuda.synchronize() so that the walk's device tail
    is its own."""

    def __init__(self):
        self.walk_s: list[float] = []

    @contextmanager
    def installed(self, sync):
        from antrea_tpu_torch.models import forwarding

        inner = forwarding.pipeline_step_full

        def walk(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function("flowbench.walk"):
                out = inner(*a, **kw)
                sync()
            self.walk_s.append(time.perf_counter() - t0)
            return out

        forwarding.pipeline_step_full = walk
        try:
            yield self
        finally:
            forwarding.pipeline_step_full = inner


class KernelCalls:
    """The inputs of each B3 and B1 call while `on`, for their byte
    counts (flowbench/roofline.py)."""

    def __init__(self):
        self.on = False
        self.b3: list = []
        self.b1: list = []

    @contextmanager
    def installed(self):
        from antrea_tpu_torch.ops import consumer, onepass

        b3, b1 = onepass.onepass, consumer.fused_hits

        def b3_call(x, tabs, now, gen_w, st, *a, **kw):
            out = b3(x, tabs, now, gen_w, st, *a, **kw)
            if self.on and kw.get("resolve", True) and len(a) < 3:
                self.b3.append((tabs, st, out[0], out[4], x.pkt.shape[0]))
            return out

        def b1_call(tabs, iv, svcref, *a, **kw):
            if self.on:
                self.b1.append((tabs, iv, svcref))
            return b1(tabs, iv, svcref, *a, **kw)

        onepass.onepass, consumer.fused_hits = b3_call, b1_call
        try:
            yield self
        finally:
            onepass.onepass, consumer.fused_hits = b3, b1


def _union(iv):
    """Sorted (start, end) intervals -> their union, merged."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(host: list) -> list:
    """One thread's nested host ranges (start, end, name) -> the timeline
    of the innermost one open, as (start, end, name) segments in order
    ("(no host op)" between ranges)."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    segs, stack = [], []
    t = host[0][0] if host else 0.0

    def emit(upto, name):
        nonlocal t
        if upto > t:
            segs.append((t, upto, name))
            t = upto

    for s, e, n in host:
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            emit(top[1], top[2])
        emit(s, stack[-1][2] if stack else "(no host op)")
        # A child that outlives its parent on the record is cut to it.
        stack.append((s, min(e, stack[-1][1]) if stack else e, n))
    while stack:
        top = stack.pop()
        emit(top[1], top[2])
    return segs


def summarize(prof, steps: int) -> dict:
    """A profiler's events -> device busy seconds (the union of every
    device interval), the traced span, kernel seconds and counts by name,
    launches, the device operations that took most time, and the device's
    idle time by what the host's stepping thread was doing then (its
    innermost open range)."""
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or \
                    ev.name.startswith("flowbench."):
                continue  # a record_function range's device copy
            dev.append((tr.start, tr.end, ev.name))
        else:
            host.append((tr.start, tr.end, ev.name, ev.thread))
    if not dev:
        return {}
    lo = min([h[0] for h in host] + [s for s, _, _ in dev])
    hi = max([h[1] for h in host] + [e for _, e, _ in dev])
    busy = _union([(s, e) for s, e, _ in dev])
    by_name = defaultdict(lambda: [0, 0.0])
    kernels = 0
    for s, e, n in dev:
        by_name[n][0] += 1
        by_name[n][1] += (e - s) * 1e-6
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            kernels += 1
    gaps = [(lo, busy[0][0])]
    gaps += [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.append((busy[-1][1], hi))
    stepping = {h[3] for h in host if h[2] == "flowbench.step"}
    segs = _innermost([h[:3] for h in host
                       if not stepping or h[3] in stepping])
    named = defaultdict(float)
    k = 0
    for gs, ge in gaps:
        covered = 0.0
        while k < len(segs) and segs[k][1] <= gs:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < ge:
            o = min(ge, segs[j][1]) - max(gs, segs[j][0])
            if o > 0:
                named[segs[j][2]] += o * 1e-6
                covered += o
            j += 1
        if ge - gs > covered:
            named["(no host op)"] += (ge - gs - covered) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top = [(n[:160], v) for n, v in top]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "span_s": (hi - lo) * 1e-6,
        "steps": steps,
        "kernels": kernels,
        "by_name": {n: (c, s) for n, (c, s) in by_name.items()},
        "device_ops": [[n, s] for n, (_, s) in top],
        "idle_gaps": [[n, s] for n, s in sorted(named.items(),
                                              key=lambda kv: -kv[1])[:10]],
    }


def kernel_seconds(summary: dict, needle: str) -> tuple[int, float]:
    c = s = 0
    for n, (k, t) in summary.get("by_name", {}).items():
        if needle in n:
            c, s = c + k, s + t
    return c, s
