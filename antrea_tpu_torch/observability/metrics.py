"""Pull-style metrics surface (Prometheus text exposition format).

The analog of the reference's agent metrics
(pkg/agent/metrics/prometheus.go:33-188: rule counts,
per-table flow counts, conntrack totals) rendered from this build's
observable state: DatapathStats (per-rule packet counters), the flow-cache
census (models/pipeline.cache_stats), the cumulative eviction counter (the
weak-#5 measurement surface) and the latency histograms (datapath step,
agent sync, controller-commit->datapath-realized dissemination).
render_metrics() is the scrape function; the simulator (or any collector)
consumes the text directly.

Exposition discipline (enforced by tests/test_prom_exposition.py's strict
parser and analysis pass `metrics`'s README drift check):
  * every emitted family is declared in METRICS (name -> type) and gets its
    `# TYPE` line from _type_line — an undeclared name cannot be emitted;
  * all label rendering goes through _labels (one escaping/formatting
    path; empty values are omitted, so node="" composes everywhere).
"""

from __future__ import annotations

import bisect

# The complete metric inventory: family name -> Prometheus type.  The ONE
# registry analysis pass `metrics` diffs against the README "Observability"
# table; render functions emit TYPE lines via _type_line so an unregistered
# family fails loudly at render time, not silently at scrape time.
METRICS: dict[str, str] = {
    # controller (render_controller_metrics)
    "antrea_tpu_controller_objects": "gauge",
    "antrea_tpu_controller_connected_agents": "gauge",
    # dissemination plane (render_dissemination_metrics)
    "antrea_tpu_dissemination_watcher_pending": "gauge",
    "antrea_tpu_dissemination_watcher_overflows_total": "counter",
    "antrea_tpu_dissemination_watcher_needs_resync": "gauge",
    "antrea_tpu_dissemination_resyncs_total": "counter",
    "antrea_tpu_dissemination_reconnects_total": "counter",
    "antrea_tpu_dissemination_queue_coalesced_total": "counter",
    "antrea_tpu_dissemination_resync_chunks_total": "counter",
    "antrea_tpu_dissemination_resyncs_inflight": "gauge",
    "antrea_tpu_agent_reconnects_total": "counter",
    "antrea_tpu_agent_resyncs_total": "counter",
    "antrea_tpu_agent_sync_failures_total": "counter",
    "antrea_tpu_agent_sync_seconds": "histogram",
    "antrea_tpu_dissemination_latency_seconds": "histogram",
    # datapath (render_metrics)
    "antrea_tpu_rule_packets_total": "counter",
    "antrea_tpu_rule_bytes_total": "counter",
    "antrea_tpu_default_verdict_packets_total": "counter",
    "antrea_tpu_flow_cache_entries": "gauge",
    "antrea_tpu_flow_cache_slots": "gauge",
    "antrea_tpu_flow_cache_evictions_total": "counter",
    "antrea_tpu_flow_cache_reclaims_total": "counter",
    "antrea_tpu_datapath_step_seconds": "histogram",
    # async slow-path engine (datapath/slowpath; rendered when the
    # datapath exposes slowpath_stats())
    "antrea_tpu_miss_queue_depth": "gauge",
    "antrea_tpu_miss_queue_capacity": "gauge",
    "antrea_tpu_miss_queue_admitted_total": "counter",
    "antrea_tpu_miss_queue_overflows_total": "counter",
    "antrea_tpu_miss_queue_early_drops_total": "counter",
    "antrea_tpu_miss_queue_source_limited_total": "counter",
    "antrea_tpu_slowpath_drained_total": "counter",
    "antrea_tpu_slowpath_stale_reclassified_total": "counter",
    "antrea_tpu_slowpath_drain_batch_size": "histogram",
    "antrea_tpu_flow_cache_epoch": "gauge",
    "antrea_tpu_flow_cache_epoch_age_seconds": "gauge",
    # overlapped drain-commit plane + drain-chunk autotuner (round 6:
    # double-buffered churn datapath; rendered with slowpath_stats())
    "antrea_tpu_slowpath_overlap_depth": "gauge",
    "antrea_tpu_slowpath_deferred_commits_total": "counter",
    "antrea_tpu_slowpath_deferred_commit_staleness_seconds": "gauge",
    "antrea_tpu_slowpath_drain_chunk": "gauge",
    "antrea_tpu_slowpath_autotune_decisions_total": "counter",
    # transactional bundle commit plane (datapath/commit.py; rendered when
    # the datapath exposes commit_stats())
    "antrea_tpu_bundle_commits_total": "counter",
    "antrea_tpu_bundle_rollbacks_total": "counter",
    "antrea_tpu_canary_probes_total": "counter",
    "antrea_tpu_canary_mismatches_total": "counter",
    "antrea_tpu_datapath_degraded": "gauge",
    "antrea_tpu_bundle_lkg_generation": "gauge",
    "antrea_tpu_bundle_lkg_age_seconds": "gauge",
    # continuous flow-cache revalidator (datapath/audit.py; rendered when
    # the datapath exposes audit_stats())
    "antrea_tpu_cache_audit_scans_total": "counter",
    "antrea_tpu_cache_audit_entries_total": "counter",
    "antrea_tpu_cache_audit_divergences_total": "counter",
    "antrea_tpu_cache_audit_repairs_total": "counter",
    "antrea_tpu_tensor_scrub_total": "counter",
    "antrea_tpu_audit_cursor_coverage_ratio": "gauge",
    # unified maintenance scheduler (datapath/maintenance.py; rendered
    # when the datapath exposes maintenance_stats())
    "antrea_tpu_maintenance_ticks_total": "counter",
    "antrea_tpu_maintenance_blocked_ticks_total": "counter",
    "antrea_tpu_maintenance_task_runs_total": "counter",
    "antrea_tpu_maintenance_budget_spent_total": "counter",
    "antrea_tpu_maintenance_deferrals_total": "counter",
    "antrea_tpu_maintenance_shed_total": "counter",
    "antrea_tpu_maintenance_scheduler_lag": "gauge",
    # realization tracing (observability/tracing.py; rendered when the
    # datapath exposes realization_stats()) + the agent-side pending-stamp
    # truncation meter (render_dissemination_metrics)
    "antrea_tpu_policy_realization_seconds": "histogram",
    "antrea_tpu_realization_spans": "gauge",
    "antrea_tpu_realization_spans_dropped_total": "counter",
    "antrea_tpu_realization_stamps_dropped_total": "counter",
    # flight recorder (observability/flightrec.py; rendered when the
    # datapath exposes flightrecorder_stats())
    "antrea_tpu_flightrecorder_events_total": "counter",
    "antrea_tpu_flightrecorder_dropped_total": "counter",
    "antrea_tpu_flightrecorder_seq": "gauge",
    # multichip datapath (parallel/meshpath.py; rendered when the
    # datapath exposes mesh_stats()) — shard-labeled families so a pod
    # slice's per-replica health is scrapeable replica-for-replica
    "antrea_tpu_replica_miss_queue_depth": "gauge",
    "antrea_tpu_replica_canary_mismatches_total": "counter",
    "antrea_tpu_replica_audit_entries_total": "counter",
    # elastic mesh resharding (parallel/reshard.py; rendered when the
    # datapath exposes reshard_stats()) — migration progress, resident
    # target rows, and the cutover/abort history of the resize plane
    "antrea_tpu_reshard_topology_generation": "gauge",
    "antrea_tpu_reshard_active": "gauge",
    "antrea_tpu_reshard_progress_ratio": "gauge",
    "antrea_tpu_reshard_migrated_rows_total": "counter",
    "antrea_tpu_reshard_resident_rows": "gauge",
    "antrea_tpu_reshard_cutovers_total": "counter",
    "antrea_tpu_reshard_aborts_total": "counter",
    "antrea_tpu_reshard_catchup_rows_total": "counter",
    "antrea_tpu_reshard_tenant_rows_total": "counter",
    "antrea_tpu_reshard_tenant_vetoes_total": "counter",
    # replica-loss failover plane (parallel/failover.py; rendered when
    # the datapath exposes failover_stats()) — the shard-labeled
    # quarantined gauge plus probe/quarantine/evacuation/readmission
    # totals and the evacuation re-miss burst meter
    "antrea_tpu_failover_quarantined": "gauge",
    "antrea_tpu_failover_probes_total": "counter",
    "antrea_tpu_failover_probe_failures_total": "counter",
    "antrea_tpu_failover_slow_dispatches_total": "counter",
    "antrea_tpu_failover_quarantines_total": "counter",
    "antrea_tpu_failover_evacuations_total": "counter",
    "antrea_tpu_failover_readmissions_total": "counter",
    "antrea_tpu_failover_remiss_total": "counter",
    # aggregated-bitmap match pruning (ops/match round 7; rendered when
    # the datapath exposes prune_stats())
    "antrea_tpu_match_prune_skips_total": "counter",
    "antrea_tpu_match_prune_fallbacks_total": "counter",
    "antrea_tpu_match_prune_candidate_superblocks": "histogram",
    "antrea_tpu_match_prune_budget": "gauge",
    "antrea_tpu_match_prune_retunes_total": "counter",
    # multi-tenant serving plane (datapath/tenancy.py; rendered when the
    # datapath exposes tenant_stats()) — tenant-labeled families so each
    # policy world's generation, quota pressure and isolation meters are
    # scrapeable tenant-for-tenant
    "antrea_tpu_tenant_worlds": "gauge",
    "antrea_tpu_tenant_generation": "gauge",
    "antrea_tpu_tenant_degraded": "gauge",
    "antrea_tpu_tenant_flow_quota_slots": "gauge",
    "antrea_tpu_tenant_flow_occupied": "gauge",
    "antrea_tpu_tenant_rule_words": "gauge",
    "antrea_tpu_tenant_evictions_total": "counter",
    "antrea_tpu_tenant_quota_clamps_total": "counter",
    "antrea_tpu_tenant_rollbacks_total": "counter",
    "antrea_tpu_tenant_topology_generation": "gauge",
    "antrea_tpu_tenant_latched": "gauge",
    "antrea_tpu_tenant_reshard_rows_total": "counter",
    "antrea_tpu_tenant_reshard_vetoes_total": "counter",
    # serving batcher (serving/batcher.py; rendered when the datapath
    # exposes serving_stats()) — admission/shed/flush meters for the
    # canonical-shape batching plane plus the {tenant}-labeled staging-
    # wait histogram (tick units; its p99 is the flush_deadline lever)
    "antrea_tpu_serving_submitted_lanes_total": "counter",
    "antrea_tpu_serving_shed_lanes_total": "counter",
    "antrea_tpu_serving_flushed_lanes_total": "counter",
    "antrea_tpu_serving_padded_lanes_total": "counter",
    "antrea_tpu_serving_dispatches_total": "counter",
    "antrea_tpu_serving_flushes_total": "counter",
    "antrea_tpu_serving_deadline_exceeded_total": "counter",
    "antrea_tpu_serving_results_dropped_total": "counter",
    "antrea_tpu_serving_staged_lanes": "gauge",
    "antrea_tpu_serving_wait_ticks": "histogram",
    # hot-path telemetry plane (observability/telemetry.py; rendered when
    # the datapath exposes telemetry_stats()) — one counter family per
    # TELEMETRY_COUNTERS name (family names resolve via
    # _TELEMETRY_FAMILIES below; the telemetry-registry analysis pass
    # pins that map against TELEMETRY_COUNTERS and this registry), the
    # regime-labeled step-latency histogram, and the sentinel's verdict
    # meter
    "antrea_tpu_telemetry_probe_hit_total": "counter",
    "antrea_tpu_telemetry_probe_stale_total": "counter",
    "antrea_tpu_telemetry_probe_miss_total": "counter",
    "antrea_tpu_telemetry_chance_bumps_total": "counter",
    "antrea_tpu_telemetry_dma_hb_total": "counter",
    "antrea_tpu_telemetry_regime_step_seconds": "histogram",
    "antrea_tpu_telemetry_perf_regressions_total": "counter",
}

# TELEMETRY_COUNTERS name -> its registered family.  An explicit literal
# map (not an f-string build) so every family name in this module is a
# greppable registered literal; the telemetry-registry analysis pass
# fails the build if the keys drift from TELEMETRY_COUNTERS or a value
# is not in METRICS.
_TELEMETRY_FAMILIES = {
    "probe_hit": "antrea_tpu_telemetry_probe_hit_total",
    "probe_stale": "antrea_tpu_telemetry_probe_stale_total",
    "probe_miss": "antrea_tpu_telemetry_probe_miss_total",
    "chance_bumps": "antrea_tpu_telemetry_chance_bumps_total",
    "dma_hb": "antrea_tpu_telemetry_dma_hb_total",
}


def _esc(s: str) -> str:
    # Label-value escaping per the exposition format: backslash, quote,
    # AND newline (a raw newline inside a quoted value splits the sample
    # line and breaks every scraper; rule names are user-controlled YAML).
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(**kv) -> str:
    """Render a label set -> '{k="v",...}' (or '' when every value is
    empty/None).  The single label-formatting path for all render
    functions: insertion order is preserved, values are escaped."""
    items = [(k, v) for k, v in kv.items() if v is not None and v != ""]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in items) + "}"


def _type_line(name: str) -> str:
    return f"# TYPE {name} {METRICS[name]}"


def _num(v: float) -> str:
    """Prometheus float formatting: integral values render bare."""
    return str(int(v)) if float(v) == int(v) else repr(float(v))


class Histogram:
    """Dependency-free Prometheus histogram (fixed upper bounds).

    The exposition contract (prometheus.io/docs/instrumenting/exposition
    _formats): cumulative `_bucket{le=...}` series ending in le="+Inf"
    (== `_count`), plus `_sum`/`_count`.  Default bounds cover the
    latencies this build observes: sub-ms device steps up to multi-second
    dissemination convergence under backoff.
    """

    DEFAULT_BOUNDS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds: tuple[float, ...] = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self._counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def add_counts(self, counts, value_sum: float = 0.0) -> None:
        """Merge DEVICE-side per-bucket counts (one int per bucket incl.
        +Inf, indexed exactly like observe's bisect_left — see
        models/pipeline._prune_bucket_counts) plus the observations'
        value sum.  Lets a jitted kernel bucket thousands of lanes on
        device and transfer one small vector instead of per-lane
        values."""
        counts = [int(c) for c in counts]
        if len(counts) != len(self._counts):
            raise ValueError(
                f"expected {len(self._counts)} bucket counts, "
                f"got {len(counts)}")
        for i, c in enumerate(counts):
            self._counts[i] += c
        self.count += sum(counts)
        self.sum += float(value_sum)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram's observations into this one (fleet
        aggregation: a cluster-wide p99 needs ONE bucket space).  Bounds
        must match — merging across bucket layouts would misbin."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.sum += other.sum
        self.count += other.count
        return self

    def quantile(self, q: float) -> float:
        """Upper-bound quantile estimate from the bucket bounds (the
        Prometheus histogram_quantile shape): the smallest bound whose
        cumulative count reaches q*count.  Observations past the last
        finite bound report that bound (the estimate saturates, exactly
        like a scrape-side histogram_quantile would).  0.0 when empty."""
        if self.count == 0:
            return 0.0
        need = max(0.0, min(1.0, float(q))) * self.count
        acc = 0
        for bound, c in zip(self.bounds, self._counts):
            acc += c
            if acc >= need:
                return bound
        return self.bounds[-1]

    def bucket_counts(self) -> list[int]:
        """CUMULATIVE per-bound counts (le semantics), +Inf last."""
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out

    def sample_lines(self, name: str, **labels) -> list[str]:
        """The family's sample lines for ONE label set (no TYPE line —
        several label sets may share a family; callers group them under a
        single _type_line)."""
        lines = []
        cum = self.bucket_counts()
        for bound, c in zip(self.bounds, cum):
            lines.append(
                f"{name}_bucket{_labels(**labels, le=_num(bound))} {c}"
            )
        lines.append(f'{name}_bucket{_labels(**labels, le="+Inf")} {self.count}')
        lines.append(f"{name}_sum{_labels(**labels)} {repr(self.sum)}")
        lines.append(f"{name}_count{_labels(**labels)} {self.count}")
        return lines


def _render_histograms(rows: list) -> list[str]:
    """[(family, labels dict, Histogram)] -> exposition lines, grouped so
    each family's TYPE line precedes all of its label sets exactly once."""
    by_family: dict[str, list] = {}
    for name, labels, hist in rows:
        by_family.setdefault(name, []).append((labels, hist))
    lines = []
    for name, series in by_family.items():
        lines.append(_type_line(name))
        for labels, hist in series:
            lines.extend(hist.sample_lines(name, **labels))
    return lines


def render_controller_metrics(controller, store=None) -> str:
    """Controller-side Prometheus text (ref pkg/controller/metrics/
    prometheus.go: antrea_controller_network_policy_processed etc. — here
    the live object gauges + the connected-agent gauge)."""
    counts = controller.object_counts()
    lines = [_type_line("antrea_tpu_controller_objects")]
    for key, kind in (
        ("networkPolicies", "network_policies"),
        ("addressGroups", "address_groups"),
        ("appliedToGroups", "applied_to_groups"),
    ):
        lines.append(
            f"antrea_tpu_controller_objects{_labels(kind=kind)} {counts[key]}"
        )
    if store is not None:
        lines += [
            _type_line("antrea_tpu_controller_connected_agents"),
            f"antrea_tpu_controller_connected_agents {store.n_watchers}",
        ]
    return "\n".join(lines) + "\n"


def render_dissemination_metrics(server=None, agents=()) -> str:
    """Dissemination-plane health in Prometheus text — the scrape surface
    for the failure model (README "Failure model"): per-watcher queue
    depth/overflow/needs-resync from the server's dissemination_stats(),
    per-agent reconnect/resync counters, the reconciler's
    sync_failures_total, and the agent-side latency histograms (sync
    duration + controller-commit->datapath-realized dissemination
    latency).

    `server` is a DisseminationServer (or None for agent-only scrapes);
    `agents` is any iterable of NetAgent and/or AgentPolicyController —
    duck-typed, so a NetAgent contributes wire counters AND its embedded
    controller's install-failure counter and histograms."""
    lines = []
    if server is not None:
        stats = server.dissemination_stats()
        watchers = sorted(stats["watchers"].items())
        lines.append(_type_line("antrea_tpu_dissemination_watcher_pending"))
        for node, w in watchers:
            lines.append(
                f"antrea_tpu_dissemination_watcher_pending{_labels(node=node)}"
                f" {w['pending']}"
            )
        lines.append(_type_line("antrea_tpu_dissemination_watcher_overflows_total"))
        for node, w in watchers:
            lines.append(
                f"antrea_tpu_dissemination_watcher_overflows_total"
                f"{_labels(node=node)} {w['overflows']}"
            )
        lines.append(_type_line("antrea_tpu_dissemination_watcher_needs_resync"))
        for node, w in watchers:
            lines.append(
                f"antrea_tpu_dissemination_watcher_needs_resync"
                f"{_labels(node=node)} {int(w['needs_resync'])}"
            )
        lines.append(
            _type_line("antrea_tpu_dissemination_queue_coalesced_total"))
        for node, w in watchers:
            lines.append(
                f"antrea_tpu_dissemination_queue_coalesced_total"
                f"{_labels(node=node)} {w.get('coalesced', 0)}"
            )
        lines += [
            _type_line("antrea_tpu_dissemination_resyncs_total"),
            f"antrea_tpu_dissemination_resyncs_total {stats['resyncs_total']}",
            _type_line("antrea_tpu_dissemination_reconnects_total"),
            f"antrea_tpu_dissemination_reconnects_total "
            f"{stats['reconnects_total']}",
            _type_line("antrea_tpu_dissemination_resync_chunks_total"),
            f"antrea_tpu_dissemination_resync_chunks_total "
            f"{stats.get('resync_chunks_total', 0)}",
            _type_line("antrea_tpu_dissemination_resyncs_inflight"),
            f"antrea_tpu_dissemination_resyncs_inflight "
            f"{stats.get('resyncs_inflight', 0)}",
        ]
    agents = list(agents)

    # A NetAgent embeds its AgentPolicyController as .agent; a bare
    # controller passed directly carries its fields itself.
    def ctl(a):
        return getattr(a, "agent", a)

    for name, read in (
        ("antrea_tpu_agent_reconnects_total",
         lambda a: getattr(a, "reconnects_total", None)),
        ("antrea_tpu_agent_resyncs_total",
         lambda a: getattr(a, "resyncs_total", None)),
        ("antrea_tpu_agent_sync_failures_total",
         lambda a: getattr(ctl(a), "sync_failures_total", None)),
        # Satellite meter: dissemination-latency stamps truncated at the
        # bounded _pending_ts cap — during exactly the install outages the
        # latency histogram exists to show, dropped stamps understate p99;
        # this counter keeps the understatement visible instead of silent.
        ("antrea_tpu_realization_stamps_dropped_total",
         lambda a: getattr(ctl(a), "realization_stamps_dropped_total", None)),
    ):
        rows = [(a.node, read(a)) for a in agents if read(a) is not None]
        if rows:
            lines.append(_type_line(name))
            for node, val in rows:
                lines.append(f"{name}{_labels(node=node)} {val}")
    hist_rows = []
    for fam, attr in (
        ("antrea_tpu_agent_sync_seconds", "sync_hist"),
        ("antrea_tpu_dissemination_latency_seconds", "dissemination_hist"),
    ):
        for a in agents:
            h = getattr(ctl(a), attr, None)
            if h is not None and h.count:
                hist_rows.append((fam, {"node": a.node}, h))
    lines.extend(_render_histograms(hist_rows))
    return "\n".join(lines) + "\n"


def render_metrics(datapath, node: str = "") -> str:
    """One Prometheus-text snapshot of a Datapath's observable state."""
    stats = datapath.stats()
    lines = [_type_line("antrea_tpu_rule_packets_total")]
    for direction, table in (("ingress", stats.ingress), ("egress", stats.egress)):
        for rule, count in sorted(table.items()):
            lines.append(
                f"antrea_tpu_rule_packets_total"
                f"{_labels(direction=direction, rule=rule, node=node)} {count}"
            )
    by_bytes = (("ingress", stats.ingress_bytes or {}),
                ("egress", stats.egress_bytes or {}))
    if any(t for _d, t in by_bytes):
        lines.append(_type_line("antrea_tpu_rule_bytes_total"))
        for direction, table in by_bytes:
            for rule, count in sorted(table.items()):
                lines.append(
                    f"antrea_tpu_rule_bytes_total"
                    f"{_labels(direction=direction, rule=rule, node=node)} "
                    f"{count}"
                )
    lines += [
        _type_line("antrea_tpu_default_verdict_packets_total"),
        f"antrea_tpu_default_verdict_packets_total"
        f"{_labels(verdict='allow', node=node)} {stats.default_allow}",
        f"antrea_tpu_default_verdict_packets_total"
        f"{_labels(verdict='deny', node=node)} {stats.default_deny}",
    ]
    cs = getattr(datapath, "cache_stats", None)
    if cs is not None:
        c = cs()
        lines.append(_type_line("antrea_tpu_flow_cache_entries"))
        for kind in ("occupied", "committed", "denials"):
            lines.append(
                f"antrea_tpu_flow_cache_entries"
                f"{_labels(kind=kind, node=node)} {c[kind]}"
            )
        lines += [
            _type_line("antrea_tpu_flow_cache_slots"),
            f"antrea_tpu_flow_cache_slots{_labels(node=node)} {c['slots']}",
            _type_line("antrea_tpu_flow_cache_evictions_total"),
            f"antrea_tpu_flow_cache_evictions_total{_labels(node=node)} "
            f"{c['evictions']}",
            _type_line("antrea_tpu_flow_cache_reclaims_total"),
            f"antrea_tpu_flow_cache_reclaims_total{_labels(node=node)} "
            f"{c.get('reclaims', 0)}",
        ]
    sp = getattr(datapath, "slowpath_stats", None)
    sp = sp() if sp is not None else None
    if sp is not None:
        # Async slow-path plane (datapath/slowpath): queue depth/capacity/
        # pressure, drained volume, and the epoch-swap bookkeeping.
        for fam, key in (
            ("antrea_tpu_miss_queue_depth", "depth"),
            ("antrea_tpu_miss_queue_capacity", "capacity"),
            ("antrea_tpu_miss_queue_admitted_total", "admitted_total"),
            ("antrea_tpu_miss_queue_overflows_total", "overflows_total"),
            # admission="drop": depth-proportional early-shed admissions
            # (0 under the other policies — mode-stable scrape surface).
            ("antrea_tpu_miss_queue_early_drops_total", "early_drops_total"),
            # Per-source-/24 admission token buckets (miss_source_rate;
            # 0 when the limiter is off — mode-stable scrape surface).
            ("antrea_tpu_miss_queue_source_limited_total",
             "source_limited_total"),
            ("antrea_tpu_slowpath_drained_total", "drained_total"),
            ("antrea_tpu_slowpath_stale_reclassified_total",
             "stale_reclassified_total"),
            ("antrea_tpu_flow_cache_epoch", "epoch"),
            ("antrea_tpu_flow_cache_epoch_age_seconds", "epoch_age_s"),
            # Overlapped drain-commit plane (two-slot staging) + the
            # autotuner's current chunk rung (== drain_batch when the
            # controller is off).
            ("antrea_tpu_slowpath_overlap_depth", "overlap_depth"),
            ("antrea_tpu_slowpath_deferred_commits_total",
             "deferred_commits_total"),
            ("antrea_tpu_slowpath_deferred_commit_staleness_seconds",
             "deferred_staleness_s"),
            ("antrea_tpu_slowpath_drain_chunk", "drain_batch"),
        ):
            lines += [_type_line(fam), f"{fam}{_labels(node=node)} {sp[key]}"]
        lines.append(_type_line("antrea_tpu_slowpath_autotune_decisions_total"))
        for direction, key in (("up", "autotune_decisions_up"),
                               ("down", "autotune_decisions_down")):
            lines.append(
                f"antrea_tpu_slowpath_autotune_decisions_total"
                f"{_labels(direction=direction, node=node)} "
                f"{sp.get(key, 0)}"
            )
        dh = sp.get("drain_hist")
        if dh is not None and dh.count:
            lines.extend(_render_histograms(
                [("antrea_tpu_slowpath_drain_batch_size", {"node": node}, dh)]
            ))
    cp = getattr(datapath, "commit_stats", None)
    cp = cp() if cp is not None else None
    if cp is not None:
        # Bundle commit plane (datapath/commit.py): per-stage outcomes,
        # rollback/canary counters, degraded flag, LKG retention.
        if cp["commits"]:
            lines.append(_type_line("antrea_tpu_bundle_commits_total"))
            for key, n in sorted(cp["commits"].items()):
                stage, outcome = key.split("/", 1)
                lines.append(
                    f"antrea_tpu_bundle_commits_total"
                    f"{_labels(stage=stage, outcome=outcome, node=node)} {n}"
                )
        for fam, key in (
            ("antrea_tpu_bundle_rollbacks_total", "rollbacks_total"),
            ("antrea_tpu_canary_probes_total", "canary_probes_total"),
            ("antrea_tpu_canary_mismatches_total", "canary_mismatches_total"),
            ("antrea_tpu_datapath_degraded", "degraded"),
            ("antrea_tpu_bundle_lkg_generation", "lkg_generation"),
        ):
            lines += [_type_line(fam), f"{fam}{_labels(node=node)} {cp[key]}"]
        lines += [
            _type_line("antrea_tpu_bundle_lkg_age_seconds"),
            f"antrea_tpu_bundle_lkg_age_seconds{_labels(node=node)} "
            f"{_num(cp['lkg_age_s'])}",
        ]
    au = getattr(datapath, "audit_stats", None)
    au = au() if au is not None else None
    if au is not None:
        # Continuous flow-cache revalidator (datapath/audit.py): scan/
        # sweep coverage, per-kind divergences, scrub outcomes, repairs.
        for fam, key in (
            ("antrea_tpu_cache_audit_scans_total", "scans_total"),
            ("antrea_tpu_cache_audit_entries_total", "entries_total"),
            ("antrea_tpu_cache_audit_repairs_total", "repairs_total"),
        ):
            lines += [_type_line(fam), f"{fam}{_labels(node=node)} {au[key]}"]
        if au["divergences"]:
            lines.append(_type_line("antrea_tpu_cache_audit_divergences_total"))
            for kind, n in sorted(au["divergences"].items()):
                lines.append(
                    f"antrea_tpu_cache_audit_divergences_total"
                    f"{_labels(kind=kind, node=node)} {n}"
                )
        if au["scrub"]:
            lines.append(_type_line("antrea_tpu_tensor_scrub_total"))
            for outcome, n in sorted(au["scrub"].items()):
                lines.append(
                    f"antrea_tpu_tensor_scrub_total"
                    f"{_labels(outcome=outcome, node=node)} {n}"
                )
        lines += [
            _type_line("antrea_tpu_audit_cursor_coverage_ratio"),
            f"antrea_tpu_audit_cursor_coverage_ratio{_labels(node=node)} "
            f"{_num(au['coverage_ratio'])}",
        ]
    mt = getattr(datapath, "maintenance_stats", None)
    mt = mt() if mt is not None else None
    if mt is not None:
        # Unified maintenance scheduler (datapath/maintenance.py): tick/
        # blocked-tick counters, per-task run/spent/deferral/shed
        # accounting, and the starvation lag gauge.
        for fam, key in (
            ("antrea_tpu_maintenance_ticks_total", "ticks_total"),
            ("antrea_tpu_maintenance_blocked_ticks_total",
             "blocked_ticks_total"),
            ("antrea_tpu_maintenance_scheduler_lag", "scheduler_lag"),
        ):
            lines += [_type_line(fam), f"{fam}{_labels(node=node)} {mt[key]}"]
        for fam, key in (
            ("antrea_tpu_maintenance_task_runs_total", "runs_total"),
            ("antrea_tpu_maintenance_budget_spent_total", "spent_total"),
            ("antrea_tpu_maintenance_deferrals_total", "deferrals_total"),
            ("antrea_tpu_maintenance_shed_total", "shed_total"),
        ):
            lines.append(_type_line(fam))
            for task, row in sorted(mt["tasks"].items()):
                lines.append(
                    f"{fam}{_labels(task=task, node=node)} {row[key]}"
                )
    rz = getattr(datapath, "realization_stats", None)
    rz = rz() if rz is not None else None
    if rz is not None:
        # Realization tracing plane (observability/tracing.py): span-table
        # occupancy by lifecycle state, drop meter, per-stage latency.
        lines.append(_type_line("antrea_tpu_realization_spans"))
        for state in ("pending", "awaiting_first_hit", "closed"):
            lines.append(
                f"antrea_tpu_realization_spans"
                f"{_labels(state=state, node=node)} {rz[state]}"
            )
        lines += [
            _type_line("antrea_tpu_realization_spans_dropped_total"),
            f"antrea_tpu_realization_spans_dropped_total{_labels(node=node)} "
            f"{rz['spans_dropped_total']}",
        ]
        tracer = getattr(datapath, "realization_tracer", None)
        if tracer is not None:
            rows = [("antrea_tpu_policy_realization_seconds",
                     {"stage": stage, "node": node}, h)
                    for stage, h in tracer.hist.items() if h.count]
            lines.extend(_render_histograms(rows))
    fr = getattr(datapath, "flightrecorder_stats", None)
    fr = fr() if fr is not None else None
    if fr is not None:
        # Flight recorder (observability/flightrec.py): per-kind volumes,
        # drop-oldest losses, and the monotonic sequence head.
        if fr["kinds"]:
            lines.append(_type_line("antrea_tpu_flightrecorder_events_total"))
            for kind, n in sorted(fr["kinds"].items()):
                lines.append(
                    f"antrea_tpu_flightrecorder_events_total"
                    f"{_labels(kind=kind, node=node)} {n}"
                )
        for fam, key in (
            ("antrea_tpu_flightrecorder_dropped_total", "dropped_total"),
            ("antrea_tpu_flightrecorder_seq", "seq"),
        ):
            lines += [_type_line(fam), f"{fam}{_labels(node=node)} {fr[key]}"]
    pr = getattr(datapath, "prune_stats", None)
    pr = pr() if pr is not None else None
    if pr is not None:
        # Aggregated-bitmap match pruning (ops/match round 7): aggregate
        # short circuits, full-width fallback redispatches, the current
        # K rung, retune volume, and the candidate-superblock spread.
        for fam, key in (
            ("antrea_tpu_match_prune_skips_total", "skips_total"),
            ("antrea_tpu_match_prune_fallbacks_total", "fallbacks_total"),
            ("antrea_tpu_match_prune_budget", "budget"),
            ("antrea_tpu_match_prune_retunes_total", "retunes_total"),
        ):
            lines += [_type_line(fam), f"{fam}{_labels(node=node)} {pr[key]}"]
        ph = pr.get("hist")
        if ph is not None and ph.count:
            lines.extend(_render_histograms(
                [("antrea_tpu_match_prune_candidate_superblocks",
                  {"node": node}, ph)]
            ))
    ms = getattr(datapath, "mesh_stats", None)
    ms = ms() if ms is not None else None
    if ms is not None:
        # Multichip datapath (parallel/meshpath.py): shard-labeled
        # per-replica families — queue pressure, canary outcomes and
        # striped-audit volume, replica-for-replica.
        lines.append(_type_line("antrea_tpu_replica_miss_queue_depth"))
        for r, depth in enumerate(ms["replica_miss_queue_depth"]):
            lines.append(
                f"antrea_tpu_replica_miss_queue_depth"
                f"{_labels(replica=r, node=node)} {depth}"
            )
        lines.append(
            _type_line("antrea_tpu_replica_canary_mismatches_total"))
        for r in range(len(ms["replica_miss_queue_depth"])):
            lines.append(
                f"antrea_tpu_replica_canary_mismatches_total"
                f"{_labels(replica=r, node=node)} "
                f"{ms['replica_canary_mismatches'].get(r, 0)}"
            )
        lines.append(_type_line("antrea_tpu_replica_audit_entries_total"))
        for r, n in enumerate(ms["replica_audit_entries"]):
            lines.append(
                f"antrea_tpu_replica_audit_entries_total"
                f"{_labels(replica=r, node=node)} {n}"
            )
    rs = getattr(datapath, "reshard_stats", None)
    rs = rs() if rs is not None else None
    if rs is not None:
        # Elastic mesh resharding (parallel/reshard.py): the live
        # affinity-topology generation, migration progress/volume, and
        # the plane's cutover/abort history — schema-stable whether or
        # not a resize is in flight.
        for fam, key in (
            ("antrea_tpu_reshard_topology_generation",
             "topology_generation"),
            ("antrea_tpu_reshard_active", "active"),
            ("antrea_tpu_reshard_progress_ratio", "progress_ratio"),
            ("antrea_tpu_reshard_migrated_rows_total",
             "migrated_rows_total"),
            ("antrea_tpu_reshard_resident_rows", "resident_rows"),
            ("antrea_tpu_reshard_cutovers_total", "cutovers_total"),
            ("antrea_tpu_reshard_aborts_total", "aborts_total"),
            ("antrea_tpu_reshard_catchup_rows_total", "catchup_rows_total"),
            ("antrea_tpu_reshard_tenant_rows_total", "tenant_rows_total"),
            ("antrea_tpu_reshard_tenant_vetoes_total",
             "tenant_vetoes_total"),
        ):
            lines += [_type_line(fam),
                      f"{fam}{_labels(node=node)} {_num(rs[key])}"]
    fs = getattr(datapath, "failover_stats", None)
    fs = fs() if fs is not None else None
    if fs is not None and fs.get("enabled"):
        # Replica-loss failover plane (parallel/failover.py): the
        # quarantined gauge scrapes shard-for-shard over the boot grid
        # (1 = masked/evacuated, awaiting readmission), beside the
        # plane's cumulative probe and lifecycle totals.
        lines.append(_type_line("antrea_tpu_failover_quarantined"))
        for r in range(fs.get("n_shards", 0)):
            q = int(fs.get("quarantined_shard") == r)
            lines.append(f"antrea_tpu_failover_quarantined"
                         f"{_labels(shard=r, node=node)} {q}")
        for fam, key in (
            ("antrea_tpu_failover_probes_total", "probes_total"),
            ("antrea_tpu_failover_probe_failures_total",
             "probe_failures_total"),
            ("antrea_tpu_failover_slow_dispatches_total",
             "slow_dispatches_total"),
            ("antrea_tpu_failover_quarantines_total", "quarantines_total"),
            ("antrea_tpu_failover_evacuations_total", "evacuations_total"),
            ("antrea_tpu_failover_readmissions_total",
             "readmissions_total"),
            ("antrea_tpu_failover_remiss_total", "remiss_total"),
        ):
            lines += [_type_line(fam),
                      f"{fam}{_labels(node=node)} {_num(fs[key])}"]
    ts = getattr(datapath, "tenant_stats", None)
    ts = ts() if ts is not None else None
    if ts:
        # Multi-tenant serving plane (datapath/tenancy.py): per-world
        # generation/degrade state, quota pressure and the isolation
        # meters, labeled {tenant} so fleet scrapes aggregate per world.
        lines += [_type_line("antrea_tpu_tenant_worlds"),
                  f"antrea_tpu_tenant_worlds{_labels(node=node)} {len(ts)}"]
        per = (
            ("antrea_tpu_tenant_generation", "generation"),
            ("antrea_tpu_tenant_degraded", "degraded"),
            ("antrea_tpu_tenant_flow_quota_slots", "quota_slots"),
            ("antrea_tpu_tenant_flow_occupied", "occupied"),
            ("antrea_tpu_tenant_rule_words", "rule_words"),
            ("antrea_tpu_tenant_evictions_total", "evictions_total"),
            ("antrea_tpu_tenant_quota_clamps_total", "quota_clamps_total"),
            ("antrea_tpu_tenant_rollbacks_total", "rollbacks_total"),
            ("antrea_tpu_tenant_topology_generation",
             "topology_generation"),
            ("antrea_tpu_tenant_latched", "latched"),
            ("antrea_tpu_tenant_reshard_rows_total", "reshard_rows_total"),
            ("antrea_tpu_tenant_reshard_vetoes_total",
             "reshard_vetoes_total"),
        )
        for fam, key in per:
            lines.append(_type_line(fam))
            for tid, row in ts.items():
                lines.append(
                    f"{fam}{_labels(tenant=tid, node=node)} {_num(row[key])}")
    sv = getattr(datapath, "serving_stats", None)
    sv = sv() if sv is not None else None
    if sv is not None:
        # Serving batcher (serving/batcher.py): admission / shed / flush
        # meters, the staged-lane gauge, and the {tenant}-labeled
        # staging-wait histogram (tick units).
        for fam, key in (
            ("antrea_tpu_serving_submitted_lanes_total", "submitted_lanes"),
            ("antrea_tpu_serving_shed_lanes_total", "shed_lanes"),
            ("antrea_tpu_serving_flushed_lanes_total", "flushed_lanes"),
            ("antrea_tpu_serving_padded_lanes_total", "padded_lanes"),
            ("antrea_tpu_serving_dispatches_total", "dispatches"),
            ("antrea_tpu_serving_deadline_exceeded_total",
             "deadline_exceeded"),
            ("antrea_tpu_serving_results_dropped_total", "results_dropped"),
            ("antrea_tpu_serving_staged_lanes", "staged_lanes"),
        ):
            lines += [_type_line(fam),
                      f"{fam}{_labels(node=node)} {_num(sv[key])}"]
        fam = "antrea_tpu_serving_flushes_total"
        lines.append(_type_line(fam))
        for reason, v in sorted(sv["flushes"].items()):
            lines.append(
                f"{fam}{_labels(reason=reason, node=node)} {_num(v)}")
        plane = getattr(datapath, "serving_plane", None)
        rows = plane.hist_rows(node) if plane is not None else []
        if rows:
            lines.extend(_render_histograms(rows))
    tel = getattr(datapath, "telemetry_stats", None)
    tel = tel() if tel is not None else None
    if tel is not None:
        # Hot-path telemetry plane (observability/telemetry.py): the
        # in-kernel counter totals (one family per TELEMETRY_COUNTERS
        # name), the sentinel's verdict meter, and the {scope, regime}-
        # labeled step-latency histograms.
        for name, v in tel["counters"].items():
            fam = _TELEMETRY_FAMILIES[name]
            lines += [_type_line(fam),
                      f"{fam}{_labels(node=node)} {v}"]
        fam = "antrea_tpu_telemetry_perf_regressions_total"
        lines += [_type_line(fam),
                  f"{fam}{_labels(node=node)} {tel['regressions_total']}"]
        plane = getattr(datapath, "telemetry_plane", None)
        rows = plane.hist_rows(node) if plane is not None else []
        if rows:
            lines.extend(_render_histograms(rows))
    sh = getattr(datapath, "step_hist", None)
    if sh is not None and sh.count:
        lines.extend(_render_histograms(
            [("antrea_tpu_datapath_step_seconds", {"node": node}, sh)]
        ))
    return "\n".join(lines) + "\n"
