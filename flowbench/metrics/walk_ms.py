"""The pipeline walk's mean host milliseconds a step: the benchmark's own
span around each call of models/forwarding.pipeline_step_full, ended by a
device synchronize so that the walk's device tail counts here (traced run,
over the window)."""

import numpy as np


def read(rec):
    w = rec.get("walk_s") or []
    return float(np.mean(w) * 1e3) if w else None
