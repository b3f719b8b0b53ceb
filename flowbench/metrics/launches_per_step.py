"""Device kernels a step in the profiled stretch (copies and sets not
counted)."""


def read(rec):
    tr = rec.get("trace") or {}
    return tr["kernels"] / tr["steps"] if tr.get("steps") else None
