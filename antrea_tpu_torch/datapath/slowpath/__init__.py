"""Asynchronous slow-path engine: decoupled miss handling for the datapath.

The synchronous pipeline classifies cache misses INLINE under ``lax.cond``
(models/pipeline.py slow path) — correct, but one miss-heavy batch stalls
the whole fast path, which is exactly the churn-regime wall the round-5
verdict measured (4.97M pps vs the 10M north star; the phase profiler
attributes it to the sequential per-round slow-path fixed costs).

This package is the OVS upcall architecture rebuilt for the TPU datapath:
the fast path only ever does cache lookups, misses are ADMITTED to a
bounded queue with a provisional verdict (ovs-vswitchd's
miss-upcall handoff; kernel flow-table miss -> userspace), and a
background engine drains the queue in LARGE COALESCED batches through the
same fused classification consumer — one big slow-path round amortizes
the per-round fixed costs that many small inline rounds pay repeatedly.
State publication is epoch-swapped: every slow-plane mutation (drain
commit, aging scan, revalidation) produces a NEW state pytree published
by a single reference swap tagged with a bumped epoch — the same
double-buffered commit discipline ``install_bundle`` already uses for
rule tensors, so the fast path always reads a consistent cache
generation.  A bundle swap marks the epoch STALE and the cache
revalidates lazily (stale-generation denials reclaimed off the hot step,
in-flight drains re-classified under the new tensors) rather than
flushing — established flows survive policy churn, per conntrack
semantics.
"""

from .engine import (ADMIT_DROP, ADMIT_FORWARD, ADMIT_HOLD, CHUNK_LADDER,
                     DrainAutotuner,
                     SlowPathEngine)
from .queue import MissQueue

__all__ = ["ADMIT_DROP", "ADMIT_FORWARD", "ADMIT_HOLD", "CHUNK_LADDER",
           "DrainAutotuner", "MissQueue", "SlowPathEngine"]
