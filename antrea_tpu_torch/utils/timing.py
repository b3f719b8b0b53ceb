"""Device timing with CUDA events: device_time for one call, and
device_loop_time, the counterpart of the JAX package's
utils/timing.device_loop_time, for a loop of steps."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

# Device cycles per second assumed when turning a host lead into a sleep
# (an H100 SM clock is at most ~2 GHz, so the lead is at least this long).
_CYCLES_PER_S = 2e9


def device_time(fn: Callable[[], object], *, iters: int = 8, warmup: int = 1,
                inner: int = 1, host_lead_s: float = 0.0) -> float:
    """Median seconds of one fn() on the current CUDA device.

    Runs fn `warmup` times, then `iters` samples of `inner` back-to-back
    calls each, bracketed by CUDA events on the current stream, with
    torch.cuda.synchronize() before the first sample and after each one.
    A sample spans the device timeline between its two events, so it also
    counts time the device waits on the host inside fn.

    host_lead_s > 0 first holds the stream in a sleep kernel for about that
    long, before the start event, so the host can queue the `inner` calls
    ahead of the device: the sample then measures the device's own time for
    them, not the host's time to issue them (for kernels shorter than their
    launch path)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if host_lead_s > 0:
            torch.cuda._sleep(int(host_lead_s * _CYCLES_PER_S))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / inner)
    return statistics.median(samples)


def _first_tensor(tree):
    """The first tensor leaf of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def device_loop_time(make_step: Callable, carry, *, k_small: int = 2,
                     k_big: int = 12, repeats: int = 3) -> float:
    """Seconds per iteration of make_step(i, carry) -> carry', from the
    difference between a k_big-iteration run and a k_small-iteration run
    (each the best of `repeats` after one warm-up run), which cancels what
    a run costs once.  Every run starts from `carry`.

    The device is the one the carry's first tensor lies on; this function
    never picks one.  On a CUDA tensor each run is bracketed by CUDA events
    after a synchronize and ends in one, so it spans the device timeline
    from the first step's launch to the last step's end.  That counts the
    host: the port's step reads values back every step (where the JAX
    package's loop runs on the device inside one fori_loop), so the time
    includes the host's share of each step, not the device's alone.  On a
    CPU tensor (the caller's choice, for the tests) runs are timed with
    perf_counter."""
    t = _first_tensor(carry)
    if t is None:
        raise ValueError("device_loop_time needs a tensor in the carry to "
                         "know its device")
    cuda = t.device.type == "cuda"

    def run(k):
        c = carry
        if cuda:
            torch.cuda.synchronize(t.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(k):
                c = make_step(i, c)
            end.record()
            torch.cuda.synchronize(t.device)
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for i in range(k):
            c = make_step(i, c)
        return time.perf_counter() - t0

    def best(k):
        run(k)  # warm-up: first launches, builds, allocator growth
        return min(run(k) for _ in range(repeats))

    t_small = best(k_small)
    t_big = best(k_big)
    return max((t_big - t_small) / (k_big - k_small), 1e-9)
