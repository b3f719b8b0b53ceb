"""Support bundle: one-call diagnostic state collection.

The analog of the reference's support-bundle machinery
(pkg/support/dump.go:43,75 — collects logs, ovs dumps,
agent state into a tar the operator uploads;
pkg/agent/supportbundlecollection drives it).  Collected here: the
datapath's observable surfaces (stats, cache census, live flow dump,
policy/service snapshot when persisted, metrics text) written as one
tar.gz — the artifact antctl/supportbundle would fetch.
"""

from __future__ import annotations

import io
import json
import tarfile
import time


def collect_bundle(
    datapath,
    out_path: str,
    *,
    node: str = "",
    now: int = 0,
    persist_dir: str | None = None,
    audit_log_path: str | None = None,
) -> list[str]:
    """Write a support bundle tar.gz; returns the member names collected.
    Individual collectors failing never abort the bundle (dump.go keeps
    going and records what it could, ref basicDumper behavior)."""
    from .metrics import render_metrics

    members: dict[str, bytes] = {}

    def add(name: str, data) -> None:
        if isinstance(data, (dict, list)):
            data = json.dumps(data, indent=2, default=str).encode()
        elif isinstance(data, str):
            data = data.encode()
        members[name] = data

    dp_type = getattr(datapath, "datapath_type", None)
    add("meta.json", {
        "node": node,
        "collected_at_unix": time.time(),
        "datapath_type": dp_type.value if dp_type is not None else "unknown",
        "generation": getattr(datapath, "generation", None),
    })

    def _stats():
        s = datapath.stats()  # one consistent snapshot
        return {
            "ingress": s.ingress,
            "egress": s.egress,
            "default_allow": s.default_allow,
            "default_deny": s.default_deny,
        }

    def _maintenance():
        ms = getattr(datapath, "maintenance_stats", None)
        body = ms() if ms is not None else None
        if body is None:
            raise ValueError("datapath has no maintenance scheduler")
        return body

    def _failover():
        fs = getattr(datapath, "failover_stats", None)
        body = fs() if fs is not None else None
        if body is None:
            raise ValueError("datapath has no failover plane surface")
        return body

    def _flightrecorder():
        # The whole retained journal: a support bundle IS the post-mortem
        # artifact, so it carries every event the ring still holds.
        fr = getattr(datapath, "flightrecorder_stats", None)
        body = fr() if fr is not None else None
        if body is None:
            raise ValueError("datapath has no flight recorder")
        body["events"] = datapath.flightrecorder_events()
        return body

    def _telemetry():
        tl = getattr(datapath, "telemetry_stats", None)
        body = tl() if tl is not None else None
        if body is None:
            raise ValueError("datapath has no telemetry plane")
        return body

    def _realization():
        rz = getattr(datapath, "realization_stats", None)
        body = rz() if rz is not None else None
        if body is None:
            raise ValueError("datapath has no realization tracer")
        body["spans"] = datapath.realization_tracer.spans()
        return body

    for name, fn in (
        ("stats.json", _stats),
        ("cache_stats.json", datapath.cache_stats),
        ("flows.json", lambda: datapath.dump_flows(now)),
        ("maintenance.json", _maintenance),
        ("failover.json", _failover),
        ("flightrecorder.json", _flightrecorder),
        ("realization.json", _realization),
        ("telemetry.json", _telemetry),
        ("metrics.prom", lambda: render_metrics(datapath, node=node)),
    ):
        try:
            add(name, fn())
        except Exception as e:  # collector failure recorded, not fatal
            add(name + ".error", f"{type(e).__name__}: {e}")
    if persist_dir is not None:
        from ..datapath import persist as dpersist

        snap = dpersist.read_json(dpersist.snapshot_path(persist_dir))
        if snap is not None:
            add("datapath_snapshot.json", snap)
    if audit_log_path is not None:
        try:
            with open(audit_log_path, "rb") as f:
                members["audit.log"] = f.read()
        except OSError as e:
            add("audit.log.error", str(e))

    with tarfile.open(out_path, "w:gz") as tar:
        for name in sorted(members):
            data = members[name]
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return sorted(members)
