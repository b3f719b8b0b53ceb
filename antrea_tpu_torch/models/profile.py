"""Churn-loop phase profiler of the pipeline step: the PyTorch port of
antrea_tpu/models/profile.py.

The slow path is run at a chain of cumulative phase masks (pipeline.PH_*),
each variant is timed with utils/timing.device_loop_time, and a phase's cost
is the telescoped difference between adjacent masks, so the breakdown sums
to the chain end's time by construction.  The workload is bench.py's churn
shape: a warmed hot set (fast-path hits) whose last n_new lanes are
replaced every step by the next window of genuinely fresh flows from a
pool, so every timed iteration pays the same miss work whichever phases are
masked.

The port's step updates its state in place, so every profile works on a
clone of the caller's state (which it never mutates), warms the clone, keeps
a snapshot of the warm state, and restores the clone from it at the first
iteration of every timed run: each run, of each chain entry, starts from
the same warm cache, as the JAX package's functional loop does.  The
restore is the same in every run, so the k_big - k_small difference
cancels it.

Every result dict carries "device": the name of the card the tensors lie
on, or "cpu".  On the card device_loop_time counts the host's share of each
step (the step reads values back); see its docstring.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.timing import device_loop_time
from . import pipeline as pl

# The cumulative mask chain: phase k's cost = t(chain[k]) - t(chain[k-1]).
# Each mask is a superset of the previous; PH_EVICT rides last because the
# eviction census reads the commit's insert targets.
PHASE_CHAIN: tuple[tuple[str, int], ...] = (
    ("fast_path", 0),
    ("miss_detect", pl.PH_SLOW),
    ("service_lb", pl.PH_SLOW | pl.PH_LB),
    # The pruned classifier's aggregate phase alone: about zero unless the
    # meta carries a prune budget.
    ("classify_summary", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM),
    ("classify", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS),
    ("cache_commit",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS | pl.PH_COMMIT),
    ("eviction_scan", pl.PH_ALL),
)

# The async cadence: entry 0 is the decoupled fast step alone (phases=0,
# misses admitted, not classified); each later entry adds one PH_ bit to
# the coalesced drain step over that step's fresh window, run as one round
# (miss_chunk == n_new).
ASYNC_PHASE_CHAIN: tuple[tuple[str, int], ...] = (
    ("async_fast_path", 0),
    ("drain_miss_detect", pl.PH_SLOW),
    ("drain_service_lb", pl.PH_SLOW | pl.PH_LB),
    ("drain_classify_summary", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM),
    ("drain_classify", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS),
    ("drain_cache_commit",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS | pl.PH_COMMIT),
    ("drain_eviction_scan", pl.PH_ALL),
)

# The overlapped cadence: iteration i runs the fast step of window i and
# the drain (drain_reclaim=True) of window i-1.
OVERLAP_PHASE_CHAIN: tuple[tuple[str, int], ...] = (
    ("overlap_fast_path", 0),
    ("overlap_miss_detect", pl.PH_SLOW),
    ("overlap_service_lb", pl.PH_SLOW | pl.PH_LB),
    ("overlap_classify_summary", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM),
    ("overlap_classify",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS),
    ("overlap_cache_commit",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS | pl.PH_COMMIT),
    ("overlap_evict_age", pl.PH_ALL),
)

# The maintenance cadence: the async cadence with one fused maintenance
# scan (pipeline._maintain_scan) riding every iteration, entry 0 included,
# so the rider cancels out of the differences.
MAINT_PHASE_CHAIN: tuple[tuple[str, int], ...] = (
    ("maint_fast_path", 0),
    ("maint_miss_detect", pl.PH_SLOW),
    ("maint_service_lb", pl.PH_SLOW | pl.PH_LB),
    ("maint_classify_summary", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM),
    ("maint_classify", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS),
    ("maint_cache_commit",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS | pl.PH_COMMIT),
    ("maint_sweep", pl.PH_ALL),
)

# The pruned async cadence, classify split at the two-level walk's seam:
# the aggregate (summary) gather, then the candidate gather with the
# fallback re-walk.
PRUNE_PHASE_CHAIN: tuple[tuple[str, int], ...] = (
    ("prune_fast_path", 0),
    ("prune_miss_detect", pl.PH_SLOW),
    ("prune_service_lb", pl.PH_SLOW | pl.PH_LB),
    ("prune_summary_gather", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM),
    ("prune_candidate_gather",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS),
    ("prune_cache_commit",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS | pl.PH_COMMIT),
    ("prune_evict", pl.PH_ALL),
)

# The one-pass async cadence: `fused_onepass` (adding PH_CLS) is the whole
# B3 pass with its fallback re-walk, one entry.
FUSED_PHASE_CHAIN: tuple[tuple[str, int], ...] = (
    ("fused_fast_path", 0),
    ("fused_miss_detect", pl.PH_SLOW),
    ("fused_service_lb", pl.PH_SLOW | pl.PH_LB),
    ("fused_summary_gather", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM),
    ("fused_onepass", pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS),
    ("fused_commit",
     pl.PH_SLOW | pl.PH_LB | pl.PH_CLS_SUM | pl.PH_CLS | pl.PH_COMMIT),
    ("fused_evict", pl.PH_ALL),
)


def device_name(t: torch.Tensor) -> str:
    """The card's name for a CUDA tensor, "cpu" for a CPU one."""
    if t.device.type == "cuda":
        return torch.cuda.get_device_name(t.device)
    return t.device.type


def _n_new(B: int, pool, n_new: Optional[int], what: str) -> int:
    if pool is None:
        raise ValueError(f"{what} profiling needs a fresh-flow pool (the "
                         f"regime under study is miss handling)")
    pool_len = int(pool[0].shape[0])
    if n_new is None:
        n_new = max(1, B // 8)
    if n_new > B or n_new >= pool_len:
        raise ValueError(
            f"n_new={n_new} must fit the batch ({B}) and pool ({pool_len})")
    return n_new


class _Loop:
    """A warm clone of the caller's state, its snapshot, and the rolling
    pool windows of the churn loop."""

    def __init__(self, meta, state, drs, dsvc, hot, pool, n_new, now0, gen):
        self.drs, self.dsvc = drs, dsvc
        self.hot, self.pool, self.n_new = hot, pool, n_new
        self.now0, self.gen = now0, gen
        self.B = int(hot[0].shape[0])
        # Warm the hot set (PH_ALL): classify + commit, then a hit pass to
        # settle the partner-refresh stamps.
        self.st = pl.clone_state(state)
        full = meta._replace(phases=pl.PH_ALL)
        for w in range(2):
            pl.pipeline_step(self.st, drs, dsvc, *hot, now0 - 2 + w, gen,
                             meta=full)
        self.base = pl.clone_state(self.st)

    def window(self, i: int) -> tuple:
        """Pool window i (clamped below at 0), as JAX's rolling offset."""
        n, pool_len = self.n_new, int(self.pool[0].shape[0])
        off = (max(i, 0) * n) % (pool_len - n)
        return tuple(p[off:off + n] for p in self.pool)

    def mixed(self, fresh) -> tuple:
        """The hot batch with its last n_new lanes replaced by `fresh`."""
        k = self.B - self.n_new
        return tuple(torch.cat([h[:k], f]) for h, f in zip(self.hot, fresh))

    def step(self, cols, i, meta):
        return pl.pipeline_step(self.st, self.drs, self.dsvc, *cols,
                                self.now0 + i, self.gen, meta=meta)

    def time(self, body, k_small, k_big, repeats) -> float:
        def make_step(i, carry):
            if i == 0:
                pl.copy_state_(self.st, self.base)
            body(i)
            return carry

        return device_loop_time(make_step, self.st, k_small=k_small,
                                k_big=k_big, repeats=repeats)


def _chain(chain, timed) -> tuple[dict, dict, float]:
    """Time every chain entry -> (cumulative, phases, total).  Raw
    telescoped differences, unclamped (jitter may make one negative), so the
    phases sum to the chain end's time."""
    cumulative: dict[str, float] = {}
    phases: dict[str, float] = {}
    prev = 0.0
    for j, (name, mask) in enumerate(chain):
        t = timed(j, mask)
        cumulative[name] = t
        phases[name] = t - prev
        prev = t
    return cumulative, phases, cumulative[chain[-1][0]]


def _result(lp, cumulative, phases, total, **head) -> dict:
    return {
        **head,
        "batch": lp.B,
        "fresh_per_step": lp.n_new,
        "phases_s": phases,
        "cumulative_s": cumulative,
        "total_s": total,
        "pps": lp.B / total,
        "phase_fractions": {k: v / total for k, v in phases.items()},
        "device": device_name(lp.st.flow.keys),
    }


def profile_churn(meta: pl.PipelineMeta, state: pl.PipelineState, drs, dsvc,
                  hot: tuple, pool: Optional[tuple] = None, *,
                  n_new: Optional[int] = None, now0: int = 1000, gen: int = 0,
                  k_small: int = 2, k_big: int = 8, repeats: int = 2,
                  chain: tuple = PHASE_CHAIN) -> dict:
    """Per-phase breakdown of the synchronous churn step -> dict.

    hot/pool are 5-tuples (src_f, dst_f, proto, sport, dport) of (n,) int32
    tensors on one device: hot is the established set (warmed before
    timing), pool supplies fresh flows (one lane per flow); each timed step
    replaces the last n_new hot lanes with the next pool window.  pool=None
    times a pure fast-path regime.  The caller's state is never mutated."""
    B = int(hot[0].shape[0])
    n_new = 0 if pool is None else _n_new(B, pool, n_new, "churn")
    lp = _Loop(meta, state, drs, dsvc, hot, pool, n_new, now0, gen)

    def timed(j, mask):
        m = meta._replace(phases=mask)

        def body(i):
            lp.step(lp.mixed(lp.window(i)) if n_new else hot, i, m)

        return lp.time(body, k_small, k_big, repeats)

    return _result(lp, *_chain(chain, timed))


def profile_churn_async(meta: pl.PipelineMeta, state: pl.PipelineState, drs,
                        dsvc, hot: tuple, pool: tuple, *,
                        n_new: Optional[int] = None, now0: int = 1000,
                        gen: int = 0, k_small: int = 2, k_big: int = 8,
                        repeats: int = 2,
                        chain: tuple = ASYNC_PHASE_CHAIN) -> dict:
    """Per-phase breakdown of the async cadence: every iteration one fast
    step over the mixed batch (phases=0: the n_new fresh lanes admitted,
    unclassified) and, from chain entry 1 on, one coalesced drain step over
    exactly that fresh window (miss_chunk == n_new, one round) at the
    entry's mask."""
    B = int(hot[0].shape[0])
    n_new = _n_new(B, pool, n_new, "async")
    lp = _Loop(meta, state, drs, dsvc, hot, pool, n_new, now0, gen)
    fast = meta._replace(phases=0)

    def timed(j, mask):
        drain = meta._replace(phases=mask, miss_chunk=n_new)

        def body(i):
            fresh = lp.window(i)
            lp.step(lp.mixed(fresh), i, fast)
            if j > 0:
                lp.step(fresh, i, drain)

        return lp.time(body, k_small, k_big, repeats)

    return _result(lp, *_chain(chain, timed), mode="async",
                   drain_batch=n_new)


def profile_churn_overlap(meta: pl.PipelineMeta, state: pl.PipelineState,
                          drs, dsvc, hot: tuple, pool: tuple, *,
                          n_new: Optional[int] = None, now0: int = 1000,
                          gen: int = 0, k_small: int = 2, k_big: int = 8,
                          repeats: int = 2,
                          chain: tuple = OVERLAP_PHASE_CHAIN) -> dict:
    """Per-phase breakdown of the overlapped cadence: iteration i runs the
    fast step over the mixed batch of window i and the drain of window i-1
    (drain_reclaim=True; iteration 0 re-drains window 0)."""
    B = int(hot[0].shape[0])
    n_new = _n_new(B, pool, n_new, "overlap")
    lp = _Loop(meta, state, drs, dsvc, hot, pool, n_new, now0, gen)
    fast = meta._replace(phases=0)

    def timed(j, mask):
        drain = meta._replace(phases=mask, miss_chunk=n_new,
                              drain_reclaim=True)

        def body(i):
            lp.step(lp.mixed(lp.window(i)), i, fast)
            if j > 0:
                lp.step(lp.window(i - 1), i, drain)

        return lp.time(body, k_small, k_big, repeats)

    return _result(lp, *_chain(chain, timed), mode="overlap",
                   drain_batch=n_new)


def profile_churn_maintenance(meta: pl.PipelineMeta,
                              state: pl.PipelineState, drs, dsvc, hot: tuple,
                              pool: tuple, *, n_new: Optional[int] = None,
                              now0: int = 1000, gen: int = 0,
                              k_small: int = 2, k_big: int = 8,
                              repeats: int = 2,
                              chain: tuple = MAINT_PHASE_CHAIN) -> dict:
    """Per-phase breakdown of the maintenance cadence: the async cadence
    with one _maintain_scan riding every iteration.  maintenance_s is the
    chain's entry 0 minus a separately timed rider-free fast step."""
    B = int(hot[0].shape[0])
    n_new = _n_new(B, pool, n_new, "maintenance")
    lp = _Loop(meta, state, drs, dsvc, hot, pool, n_new, now0, gen)
    fast = meta._replace(phases=0)

    def timed_with(mask, with_drain, with_maint):
        drain = meta._replace(phases=mask, miss_chunk=n_new)

        def body(i):
            fresh = lp.window(i)
            lp.step(lp.mixed(fresh), i, fast)
            if with_drain:
                lp.step(fresh, i, drain)
            if with_maint:
                # gen is unchanged and now advances 1 s a step against
                # hour-scale timeouts: real work that reclaims nothing.
                pl._maintain_scan(lp.st, now0 + i, gen,
                                  timeouts=meta.timeouts)

        return lp.time(body, k_small, k_big, repeats)

    cumulative, phases, total = _chain(
        chain, lambda j, mask: timed_with(mask, j > 0, True))
    maintenance_s = cumulative[chain[0][0]] - timed_with(0, False, False)
    return _result(lp, cumulative, phases, total, mode="maintenance",
                   drain_batch=n_new, maintenance_s=maintenance_s,
                   maintenance_fraction=maintenance_s / total)


def profile_churn_prune(meta: pl.PipelineMeta, state: pl.PipelineState, drs,
                        dsvc, hot: tuple, pool: tuple, *,
                        n_new: Optional[int] = None, now0: int = 1000,
                        gen: int = 0, k_small: int = 2, k_big: int = 8,
                        repeats: int = 2,
                        chain: tuple = PRUNE_PHASE_CHAIN) -> dict:
    """The async cadence over a prune_budget > 0 meta, on
    PRUNE_PHASE_CHAIN."""
    if meta.match.prune_budget <= 0:
        raise ValueError(
            "profile_churn_prune needs a prune_budget > 0 meta (the "
            "two-level walk is off at 0)")
    out = profile_churn_async(
        meta, state, drs, dsvc, hot, pool, n_new=n_new, now0=now0, gen=gen,
        k_small=k_small, k_big=k_big, repeats=repeats, chain=chain)
    out["mode"] = "prune"
    out["prune_budget"] = meta.match.prune_budget
    return out


def profile_churn_fused(meta: pl.PipelineMeta, state: pl.PipelineState, drs,
                        dsvc, hot: tuple, pool: tuple, *,
                        n_new: Optional[int] = None, now0: int = 1000,
                        gen: int = 0, k_small: int = 2, k_big: int = 8,
                        repeats: int = 2,
                        chain: tuple = FUSED_PHASE_CHAIN) -> dict:
    """The async cadence over a one-pass meta, on FUSED_PHASE_CHAIN."""
    if not meta.onepass:
        raise ValueError(
            "profile_churn_fused needs a one-pass meta (fused=True with "
            "prune_budget > 0)")
    out = profile_churn_async(
        meta, state, drs, dsvc, hot, pool, n_new=n_new, now0=now0, gen=gen,
        k_small=k_small, k_big=k_big, repeats=repeats, chain=chain)
    out["mode"] = "fused"
    out["prune_budget"] = meta.match.prune_budget
    return out
