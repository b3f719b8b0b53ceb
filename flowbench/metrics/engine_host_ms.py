"""The engine's host surface, mean milliseconds a step: the step's wall
time less the walk span (host columns uploaded, outputs read back, rule
ids, counters), over the traced run's window."""

import numpy as np


def read(rec):
    w = rec.get("walk_s") or []
    if not w or len(w) != len(rec["lat_s"]):
        return None
    return float((np.mean(rec["lat_s"]) - np.mean(w)) * 1e3)
