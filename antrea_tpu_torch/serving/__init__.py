"""Serving admission plane — canonical-shape batching in front of the
engine's step dispatch (a copy of the JAX package's serving/).

`ServingBatcher` stages per-tenant lane submissions in bounded per-world
rings, packs them onto a small declared ladder of pow2 canonical batch
sizes (compile count bounded by rungs x ladder, never by traffic), and
flushes on a depth-OR-deadline policy driven by the maintenance
scheduler's tick clock.  Padded lanes ride the engines' `valid` mask, so
padding never mutates flow state; on the port the bound is on dispatch
signatures (rung x canonical size) rather than compiled executables.
"""

from .batcher import CANONICAL_SIZES, ServingBatcher

__all__ = ["CANONICAL_SIZES", "ServingBatcher"]
