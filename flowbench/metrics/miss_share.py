"""Flow-cache misses over lanes in the window: the sum of the steps'
StepResult.n_miss over the lanes stepped."""


def read(rec):
    n = rec["steps"] * rec["batch"]
    return sum(rec["n_miss_window"]) / n if n else None
