"""B3 (the one-pass kernel): its rows-once bytes over the card's HBM rate,
as a share of its device time in the profiled stretch, in percent."""

from flowbench.peaks import HBM_BYTES_S
from flowbench.trace import B3_KERNEL, kernel_seconds


def read(rec):
    tr = rec.get("trace") or {}
    n, s = kernel_seconds(tr, B3_KERNEL)
    if not n or not s or not tr.get("b3_calls"):
        return None
    return 100.0 * tr["b3_bytes"] / HBM_BYTES_S / s
