"""Bounded miss queue: the upcall buffer between fast path and engine.

Columnar ring buffer of admitted cache-miss packets (host-resident numpy
— admission happens on the host side of the step boundary, where the
batch columns already live).  Bounded by construction: when the ring is
full the OVERFLOW policy is tail-drop with accounting, mirroring the
kernel datapath's bounded upcall sockets (ovs-vswitchd drops upcalls
under load and counts them; an unbounded queue would just move the
miss-storm stall into host memory).  A dropped admission is not lost
traffic — the packet already carried its provisional verdict; the FLOW
simply stays unclassified until a later packet of it re-misses and
re-admits.
"""

from __future__ import annotations

import numpy as np

# One row per admitted packet.  flags/lens ride along so the drain step
# can reconstruct the no-commit gating (multicast / FIN-RST misses) and
# the per-flow volume contribution exactly as the synchronous slow path
# would have seen them; `tenant` is the owning policy world (0 = the
# default world — datapath/tenancy.py partitions drains by it, and
# tools/check_tenant.py fails the build if the schema drops it);
# epoch/enq_ts are observability (dump + epoch-age).
COLUMNS = (
    "src_ip", "dst_ip", "proto", "src_port", "dst_port",
    "flags", "lens", "tenant", "epoch", "enq_ts",
)

class MissQueue:
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"miss queue capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        # int64 lanes: src/dst are raw u32 values and must not sign-wrap.
        self._buf = {c: np.zeros(self.capacity, np.int64) for c in COLUMNS}
        self._head = 0  # next pop position
        self._size = 0
        self.admitted_total = 0
        self.overflows_total = 0  # admissions tail-dropped on a full ring
        self.drained_total = 0

    @property
    def depth(self) -> int:
        return self._size

    def _slots(self, start: int, n: int) -> np.ndarray:
        return (start + np.arange(n)) % self.capacity

    def _append(self, cols: dict, idx: np.ndarray, names) -> tuple:
        """The ONE bounded-ring append: write `idx`-selected rows of the
        `names` columns, tail-dropping past capacity (keep arrival order,
        drop newest; drops metered in overflows_total).  -> (written
        positions or None, selected indices, dropped count)."""
        room = self.capacity - self._size
        take = min(int(idx.size), room)
        dropped = int(idx.size) - take
        pos = None
        if take:
            sel = idx[:take]
            pos = self._slots(self._head + self._size, take)
            for c in names:
                self._buf[c][pos] = np.asarray(cols[c]).astype(np.int64)[sel]
            self._size += take
        self.overflows_total += dropped
        return pos, take, dropped

    def admit(self, cols: dict, mask: np.ndarray, epoch: int, now: int
              ) -> tuple[int, int]:
        """Append the masked lanes -> (admitted, dropped).  cols maps the
        5-tuple/flags/lens column names to (B,) arrays; `mask` selects the
        miss lanes the fast step produced."""
        idx = np.nonzero(np.asarray(mask, bool))[0]
        if idx.size == 0:
            return 0, 0
        if "tenant" not in cols:
            # Hand-built admission columns (tests, tools) predate the
            # tenant column: default-world rows.
            cols = dict(cols)
            cols["tenant"] = np.zeros(
                np.asarray(cols["src_ip"]).shape[0], np.int64)
        pos, take, dropped = self._append(
            cols, idx, ("src_ip", "dst_ip", "proto", "src_port", "dst_port",
                        "flags", "lens", "tenant"))
        if take:
            self._buf["epoch"][pos] = epoch
            self._buf["enq_ts"][pos] = now
            self.admitted_total += take
        return take, dropped

    def requeue(self, block: dict, idx) -> tuple[int, int]:
        """Append selected rows of a popped block VERBATIM (epoch/enq_ts
        preserved) -> (requeued, dropped).  The reshard re-route path
        (parallel/meshpath.MeshSlowPath.resize): these are not
        admissions, so `admitted_total` is untouched; rows that do not
        fit tail-drop into `overflows_total` — the ordinary bounded-queue
        contract, the flow re-admits on its next miss."""
        _pos, take, dropped = self._append(block, np.asarray(idx), COLUMNS)
        return take, dropped

    def pop(self, n: int) -> dict | None:
        """FIFO-pop up to n rows -> column dict (or None when empty)."""
        k = min(int(n), self._size)
        if k <= 0:
            return None
        pos = self._slots(self._head, k)
        block = {c: self._buf[c][pos].copy() for c in COLUMNS}
        self._head = (self._head + k) % self.capacity
        self._size -= k
        self.drained_total += k
        return block

    def contains(self, src_ip: int, dst_ip: int, proto: int,
                 src_port: int, dst_port: int) -> bool:
        """Is this exact 5-tuple queued?  On-demand vectorized scan over
        the live ring rows — trace overlays are rare and the ring is
        bounded, so the hot admit/pop paths carry no per-packet
        bookkeeping for this."""
        if self._size == 0:
            return False
        pos = self._slots(self._head, self._size)
        return bool(np.any(
            (self._buf["src_ip"][pos] == src_ip)
            & (self._buf["dst_ip"][pos] == dst_ip)
            & (self._buf["proto"][pos] == proto)
            & (self._buf["src_port"][pos] == src_port)
            & (self._buf["dst_port"][pos] == dst_port)
        ))

    def dump(self) -> list[dict]:
        """Queued rows in FIFO order as host dicts (raw u32 addresses) —
        the queued-state half of the conntrack dump."""
        pos = self._slots(self._head, self._size)
        return [
            {c: int(self._buf[c][p]) for c in COLUMNS}
            for p in pos
        ]
