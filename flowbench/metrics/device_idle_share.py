"""1 - the union of the device's intervals (kernels, copies, sets) over
the profiled stretch's span."""


def read(rec):
    tr = rec.get("trace") or {}
    if not tr.get("span_s"):
        return None
    return 1.0 - tr["busy_s"] / tr["span_s"]
