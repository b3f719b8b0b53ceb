"""Flow export + aggregation: conntrack-poll -> flow records -> biflows.

The analog of the reference's flow-visibility pipeline
(pkg/agent/flowexporter — conntrack polling into a
connection store, exported as IPFIX records — feeding
pkg/flowaggregator/flowaggregator.go:90-104, which correlates the two
directions and fans out to sinks).  The wire format here is JSON lines
(one record per flow event), the correlation semantics are the same:

  FlowExporter.poll(now)  diffs the datapath's dump_flows() against the
      connection store; NEW connections and active refreshes export
      records; connections gone past the idle timeout export a final
      record with reason=idle-end.
  FlowAggregator.ingest() merges forward and reply records of one
      connection into a single biflow keyed on the forward tuple.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional


def _key(rec: dict) -> tuple:
    return (rec["src"], rec["dst"], rec["sport"], rec["dport"], rec["proto"],
            rec["reply"])


class DenyRing:
    """Bounded ring of deny events (policy-DROP verdicts and shed
    admissions) awaiting export — the denied-connection store of the
    reference exporter (pkg/agent/flowexporter/exporter.go polls a deny
    connection store alongside conntrack, so dropped traffic is visible
    in flow records, not only as counters).  Drop-OLDEST on overflow,
    never backpressure: losing the oldest unexported deny event is the
    observability failure mode; stalling the datapath step is not."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self.recorded_total = 0
        self.dropped_total = 0  # overwritten-before-export (drop-oldest)

    def __len__(self) -> int:
        return len(self._buf)

    def record(self, rec: dict) -> None:
        if len(self._buf) == self.capacity:
            self.dropped_total += 1
        self._buf.append(rec)
        self.recorded_total += 1

    def drain(self) -> list[dict]:
        out = list(self._buf)
        self._buf.clear()
        return out


@dataclass
class _Conn:
    first_seen: int
    last_seen: int
    last_export: int
    # Last-known cumulative volumes, carried so the final idle-end record
    # reports them — the live dump no longer holds the entry by then.
    packets: int = 0
    bytes: int = 0


class FlowExporter:
    """Per-node exporter: one instance polls one datapath."""

    def __init__(
        self,
        datapath,
        node: str = "",
        active_timeout_s: int = 60,
        sink: Optional[Callable[[dict], None]] = None,
        path: Optional[str] = None,
        keep_records: Optional[bool] = None,
    ):
        self.datapath = datapath
        self.node = node
        self.active_timeout_s = active_timeout_s
        self._conns: dict[tuple, _Conn] = {}
        # The in-memory record log is a convenience for consumers with no
        # sink/path; with one configured it would grow without bound over
        # the process lifetime, so it defaults OFF then.
        self._keep = (sink is None and path is None) if keep_records is None \
            else keep_records
        self.records: list[dict] = []
        self._sink = sink
        self.path = path
        # path= is sugar for a JSONL log sink (one format, one place).
        self._path_sink = JsonlFileSink(path) if path is not None else None
        # Attaching an exporter turns the datapath's deny plane on (the
        # ring only costs anything once someone will drain it); datapaths
        # without one (test doubles) simply export no deny records.
        enable = getattr(datapath, "enable_deny_export", None)
        if enable is not None:
            enable()

    def _emit(self, rec: dict) -> None:
        if self._keep:
            self.records.append(rec)
        if self._sink is not None:
            self._sink(rec)
        if self._path_sink is not None:
            self._path_sink(rec)

    def poll(self, now: int) -> int:
        """One conntrack-poll cycle; returns records emitted."""
        emitted = 0
        seen: set = set()
        for rec in self.datapath.dump_flows(now):
            k = _key(rec)
            seen.add(k)
            st = self._conns.get(k)
            if st is None:
                st = self._conns[k] = _Conn(rec["last_seen"],
                                            rec["last_seen"], now)
                self._emit({**rec, "node": self.node, "event": "new",
                            "export_ts": now})
                emitted += 1
            else:
                st.last_seen = rec["last_seen"]
                if now - st.last_export >= self.active_timeout_s:
                    st.last_export = now
                    self._emit({**rec, "node": self.node, "event": "active",
                                "export_ts": now})
                    emitted += 1
            # Carry the cumulative volumes on EVERY poll, not only export
            # polls — the final idle-end record must report the last-known
            # counters, and by then the entry has left the live dump.
            # Max-fold: an evicted-and-recreated entry restarts its
            # cumulative counters (same reasoning as the aggregator's
            # fold), so pre-eviction volume is a floor, never regressed.
            st.packets = max(st.packets, rec.get("packets", 0))
            st.bytes = max(st.bytes, rec.get("bytes", 0))
        # Connections that left the live dump ended (idle timeout/evicted).
        for k in [k for k in self._conns if k not in seen]:
            st = self._conns.pop(k)
            src, dst, sport, dport, proto, reply = k
            self._emit({
                "src": src, "dst": dst, "sport": sport, "dport": dport,
                "proto": proto, "reply": reply, "node": self.node,
                "event": "end", "reason": "idle-end",
                "last_seen": st.last_seen,
                "packets": st.packets, "bytes": st.bytes,
                "export_ts": now,
            })
            emitted += 1
        # Deny plane: policy-DROP verdicts and shed admissions recorded by
        # the datapath since the last poll export as event="deny" records
        # (the reference's deny connection store export path).
        drain = getattr(self.datapath, "deny_drain", None)
        if drain is not None:
            for rec in drain():
                self._emit({**rec, "node": self.node, "event": "deny",
                            "export_ts": now})
                emitted += 1
        return emitted


class JsonlFileSink:
    """Log exporter analog (flowaggregator logger exporter): one JSON line
    per record appended to a file."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, rec: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")


class TableSink:
    """ClickHouse-exporter analog: records land as rows in an in-memory
    table with a fixed column set, queryable by equality filters (the
    export schema of pkg/flowaggregator/clickhouseclient)."""

    COLUMNS = (
        "src", "dst", "sport", "dport", "proto", "node", "event",
        "reason", "reply", "export_ts",
    )

    def __init__(self):
        self.rows: list[tuple] = []

    def __call__(self, rec: dict) -> None:
        self.rows.append(tuple(rec.get(c) for c in self.COLUMNS))

    def query(self, **eq) -> list[tuple]:
        idx = {c: i for i, c in enumerate(self.COLUMNS)}
        return [
            r for r in self.rows
            if all(r[idx[k]] == v for k, v in eq.items())
        ]


class BatchDirSink:
    """S3-uploader analog (pkg/flowaggregator s3uploader): records buffer
    into objects of `batch_size` and each full batch is written as one
    object file in the target directory; flush() uploads a partial tail."""

    def __init__(self, directory: str, batch_size: int = 100):
        import os
        import re

        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.batch_size = batch_size
        self._buf: list[dict] = []
        # Resume past existing objects — restarting over a populated
        # directory must append, never overwrite exported batches.
        taken = [
            int(m.group(1))
            for f in os.listdir(directory)
            if (m := re.fullmatch(r"records-(\d{6})\.jsonl", f))
        ]
        self._n_objects = max(taken) + 1 if taken else 0

    def __call__(self, rec: dict) -> None:
        self._buf.append(rec)
        if len(self._buf) >= self.batch_size:
            self.flush()

    def flush(self) -> Optional[str]:
        import os

        if not self._buf:
            return None
        path = os.path.join(self.dir, f"records-{self._n_objects:06d}.jsonl")
        with open(path, "w") as f:
            for rec in self._buf:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._n_objects += 1
        self._buf = []
        return path


def fanout(*sinks) -> Callable[[dict], None]:
    """Compose sinks into one FlowExporter/aggregator callback — the
    aggregator's multi-exporter fan-out
    (pkg/flowaggregator/flowaggregator.go:90-104 wiring IPFIX + ClickHouse
    + S3 + log exporters side by side)."""

    def emit(rec: dict) -> None:
        for s in sinks:
            s(rec)

    return emit


class FlowAggregator:
    """Correlates the two directions of a connection into one biflow (the
    flowaggregator correlation step): reply records fold into the forward
    record keyed on the forward tuple."""

    def __init__(self):
        self.biflows: dict[tuple, dict] = {}
        # reply tuple -> forward biflow key, so reply 'end' records (which
        # carry no un-DNAT fields) can still find their biflow.
        self._fwd_of_reply: dict[tuple, tuple] = {}

    def ingest(self, rec: dict) -> None:
        if rec.get("event") == "end":
            # Expire the correlated biflow (the reference aggregator
            # expires records too — without this the table grows with
            # cumulative connection count forever).
            rkey = (rec["src"], rec["dst"], rec["sport"], rec["dport"],
                    rec["proto"])
            if rec["reply"]:
                fkey = self._fwd_of_reply.pop(rkey, None)
                if fkey is not None:
                    self.biflows.pop(fkey, None)
            else:
                self.biflows.pop(rkey, None)
            return
        if rec["reply"]:
            # Reply tuple (ep -> client, ports swapped); its forward tuple
            # is (client=dst, frontend=dnat_ip, sport=dport, dport=
            # dnat_port) — the un-DNAT info the record carries.  A
            # reply-first arrival creates a PLACEHOLDER with forward-
            # oriented fields (dump order is hash-slot order, so either
            # direction can be seen first); the forward record later
            # fills in its richer fields.
            fkey = (rec["dst"], rec["dnat_ip"], rec["dport"],
                    rec["dnat_port"], rec["proto"])
            self._fwd_of_reply[
                (rec["src"], rec["dst"], rec["sport"], rec["dport"],
                 rec["proto"])
            ] = fkey
            bf = self.biflows.get(fkey)
            if bf is None:
                bf = self.biflows[fkey] = {
                    "src": rec["dst"], "dst": rec["dnat_ip"],
                    "sport": rec["dport"], "dport": rec["dnat_port"],
                    "proto": rec["proto"], "reply": False,
                    "node": rec.get("node", ""), "event": rec.get("event"),
                    "last_seen": rec["last_seen"],
                    "_placeholder": True,
                }
            bf["reply_seen"] = True
            bf["last_seen"] = max(bf["last_seen"], rec["last_seen"])
            # Reply-direction volumes fold in as the biflow's reverse
            # counters (the Reverse* IPFIX elements the reference
            # aggregator emits).  Entry counters are cumulative but RESET
            # when a cache eviction recreates the entry — fold with max so
            # aggregated totals never regress (pre-eviction volume is a
            # floor, not recoverable).
            bf["reverse_packets"] = max(bf.get("reverse_packets", 0),
                                        rec.get("packets", 0))
            bf["reverse_bytes"] = max(bf.get("reverse_bytes", 0),
                                      rec.get("bytes", 0))
            return
        fkey = (rec["src"], rec["dst"], rec["sport"], rec["dport"], rec["proto"])
        bf = self.biflows.get(fkey)
        if bf is None:
            self.biflows[fkey] = {**rec, "reply_seen": False}
            return
        if bf.pop("_placeholder", None):
            seen_reply = bf.get("reply_seen", False)
            rev_p = bf.get("reverse_packets")
            rev_b = bf.get("reverse_bytes")
            last = bf["last_seen"]
            bf.clear()
            bf.update(rec, reply_seen=seen_reply)
            if rev_p is not None:
                bf["reverse_packets"], bf["reverse_bytes"] = rev_p, rev_b
            bf["last_seen"] = max(last, rec["last_seen"])
        else:
            bf["last_seen"] = max(bf["last_seen"], rec["last_seen"])
            # Forward-direction volumes: max-fold (see the reverse-side
            # comment — an evicted-and-recreated entry restarts its
            # cumulative counters).
            if "packets" in rec:
                bf["packets"] = max(bf.get("packets", 0), rec["packets"])
                bf["bytes"] = max(bf.get("bytes", 0), rec.get("bytes", 0))

    def snapshot(self) -> list[dict]:
        return [dict(v) for _, v in sorted(self.biflows.items())]
