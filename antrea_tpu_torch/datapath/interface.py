"""The datapath plugin boundary.

Analog of the reference's OVS datapath-type seam: `OVSDatapathType` at
pkg/ovs/ovsconfig/interfaces.go:24 (sole upstream value
"system" at :33, surfaced via GetOVSDatapathType :82) plus the semantic
surface of the agent's openflow client (install/uninstall + atomic bundle
transactions, pkg/ovs/openflow/ofctrl_bridge.go:468 AddFlowsInBundle).

Everything above this boundary (controllers, dissemination, tests) drives a
`Datapath` and never imports kernel internals; `tpuflow` (the TPU kernel)
and `oracle` (the scalar reference implementation — this build's stand-in
for OVSDatapathSystem in differential tests) are interchangeable behind it.

Bundle semantics: `install_bundle` atomically replaces rule/service state
and returns the new generation; in tpuflow this is the double-buffered
(drs', dsvc', gen+1) tensor swap.  `apply_group_delta` is the incremental
path (address-group watch deltas, docs/design/architecture.md:61-62):
bounded host work + a small device upload, no recompile.

Both install paths are TRANSACTIONAL (datapath/commit.py): every commit
runs compile -> canary -> atomic swap -> settle, a canary-rejected or
compile-failed candidate rolls back to the retained last-known-good
bundle, and a rolled-back datapath serves LKG verdicts in a visible
degraded mode (deltas raise BundleQuarantinedError) until a full-bundle
recompile passes its canary.  The commit surface on every datapath:
`degraded`, `commit_stats()`, `canary_scan(now)` (the off-hot-step
live-bundle watchdog), `arm_commit_faults(plan, name)` (chaos tier).
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..apis.service import ServiceEntry
from ..compiler.ir import PolicySet
from ..packet import PacketBatch


class DatapathType(str, enum.Enum):
    TPUFLOW = "tpuflow"
    ORACLE = "oracle"


@dataclass
class StepResult:
    """Batched verdict output; all arrays shape (B,).

    rule ids are stable string identities (compiler.ir.rule_id); None where
    no explicit rule decided (default allow / K8s default deny).
    """

    code: np.ndarray  # 0 allow / 1 drop / 2 reject
    est: np.ndarray  # 0/1 — established-connection fast-path hit
    svc_idx: np.ndarray  # -1 = not a service
    dnat_ip: np.ndarray  # u32, post-DNAT destination; on reply=1 packets:
    #   the UN-DNAT rewrite (frontend ip the reply's SOURCE is restored to)
    dnat_port: np.ndarray
    ingress_rule: list  # Optional[str] per packet
    egress_rule: list
    committed: np.ndarray  # 0/1 — conntrack commit happened this step
    n_miss: int
    # 0/1 — the lane was a cache miss ADMITTED to the async miss queue
    # (datapath/slowpath): its `code` is the admission policy's
    # PROVISIONAL verdict (default-forward ALLOW or hold DROP), not a
    # classification; the flow's real verdict lands when the background
    # engine drains the queue.  None on synchronous datapaths (misses
    # classify inline).
    pending: np.ndarray = None
    # 0/1 — reverse-tuple (reply-direction) conntrack hit: the packet is the
    # reply leg of a committed connection (endpoint -> client); dnat_ip/
    # dnat_port then carry the un-DNAT source rewrite (ref UnSNAT/
    # ConntrackState tables, pipeline.go:114-195; ovs-pipeline.md ct).
    reply: np.ndarray = None
    # 0 none / 1 tcp-rst / 2 icmp-port-unreachable — the packet-out synth
    # the agent would emit for a REJECT verdict (ref pkg/agent/controller/
    # networkpolicy/reject.go).
    reject_kind: np.ndarray = None
    # 0/1 — SNAT mark: external-frontend service traffic (NodePort /
    # LoadBalancer IP) under externalTrafficPolicy=Cluster must be
    # masqueraded so return traffic re-traverses this node (ref
    # pipeline.go SNATMark/NodePortMark tables, proxier.go).
    snat: np.ndarray = None
    # Forwarding plane (populated once a topology is installed; ref
    # pipeline.go SpoofGuard/L2ForwardingCalc/L3Forwarding/TrafficControl/
    # L3DecTTL/Output tables — see compiler/topology.py):
    spoofed: np.ndarray = None  # 0/1 SpoofGuard drop (src != ingress-port binding)
    fwd_kind: np.ndarray = None  # topology.FWD_* disposition
    out_port: np.ndarray = None  # output ofport; -1 = not deliverable
    peer_ip: np.ndarray = None  # u32 tunnel peer node IP (FWD_TUNNEL only)
    dec_ttl: np.ndarray = None  # 0/1 routed leg -> decrement TTL
    tc_act: np.ndarray = None  # topology.TC_* effective TrafficControl action
    tc_port: np.ndarray = None  # TC mirror/redirect target port
    # 0/1 — punted to the controller instead of forwarded (IGMP membership
    # traffic; ref packetin.go PacketInCategoryIGMP).  Punted lanes touch no
    # conntrack/policy state.
    punt: np.ndarray = None
    # Joined-group table row for FWD_MCAST lanes (-1 otherwise); resolve the
    # replication set via Datapath.mcast_group(idx).
    mcast_idx: np.ndarray = None
    # 0/1 — allowed by an L7 rule: hand the packet to the L7 engine over
    # the VLAN seam instead of normal output (ref network_policy.go:2213
    # l7NPTrafficControlFlows; reg0 L7 redirect bit, fields.go).
    l7_redirect: np.ndarray = None
    # 0/1 — DSR delivery (ref pipeline.go:145 DSRServiceMarkTable, DSR
    # service flows :698-708): dnat_ip/dnat_port carry the SELECTED
    # endpoint (it drives out_port/forwarding), but the emitted packet's L3
    # destination must NOT be rewritten and no SNAT applies; the endpoint
    # owns the VIP and replies directly to the client, so no reply-direction
    # conntrack leg exists on this node.
    dsr: np.ndarray = None
    # Dual-stack views (populated only by dual_stack datapaths): per-lane
    # COMBINED-keyspace ints (utils/ip.py — v4 lanes carry their plain u32
    # value, so these are strict supersets of dnat_ip/peer_ip).  Python
    # lists because v6 addresses exceed any numpy integer lane width.
    dnat_key: list = None  # post-DNAT dst (reply lanes: un-DNAT rewrite)
    peer_key: list = None  # tunnel peer (FWD_TUNNEL lanes; else 0)


class Datapath(ABC):
    """One datapath instance == one node's dataplane (the OVS bridge analog)."""

    @property
    @abstractmethod
    def datapath_type(self) -> DatapathType: ...

    @property
    @abstractmethod
    def generation(self) -> int:
        """Current bundle generation (cookie-round analog)."""

    @abstractmethod
    def install_bundle(
        self,
        ps: Optional[PolicySet] = None,
        services: Optional[list[ServiceEntry]] = None,
    ) -> int:
        """Atomically replace the policy set and/or service set; returns the
        new generation.  Established connections survive; cached denials are
        invalidated (ovs-pipeline.md:1685-1691 semantics)."""

    @abstractmethod
    def apply_group_delta(
        self,
        group_name: str,
        added_ips: list[str],
        removed_ips: list[str],
    ) -> int:
        """Incremental membership update for a named AddressGroup or
        AppliedToGroup; returns the new generation."""

    @abstractmethod
    def install_topology(self, topo) -> None:
        """Atomically swap this node's forwarding topology
        (compiler/topology.Topology: local pods, remote node routes,
        TrafficControl marks).  The analog of the noderoute controller +
        CNI flow installs reprogramming L2ForwardingCalc/L3Forwarding
        (pkg/agent/controller/noderoute, cniserver).  Does not bump the
        rule generation: forwarding is stateless per-packet, so no cached
        verdict can go stale."""

    @abstractmethod
    def step(self, batch: PacketBatch, now: int) -> StepResult:
        """Process one packet batch through the full stateful pipeline."""

    @abstractmethod
    def stats(self) -> "DatapathStats":
        """Per-rule packet counters — the IngressMetric/EgressMetric table
        analog (ref pkg/agent/openflow/pipeline.go metric tables; collection
        path network_policy.go:2034 NetworkPolicyMetrics)."""

    @abstractmethod
    def trace(self, batch: PacketBatch, now: int) -> list[dict]:
        """Read-only per-packet pipeline trace (the Traceflow analog, ref
        pkg/agent/openflow/framework.go:328-338 flowsToTrace): for each
        packet, the stage-by-stage observations WITHOUT mutating any state.
        Keys: cache_hit, est, svc_idx, dnat_ip, dnat_port, egress_code,
        egress_rule, ingress_code, ingress_rule, code."""

    # -- transactional commit surface (datapath/commit.py; both engines
    # override via the TransactionalDatapath mixin — these are the inert
    # defaults for datapaths without a commit plane, e.g. test doubles) ------

    degraded = False  # serving LKG after a rollback; deltas quarantined

    def commit_stats(self) -> Optional[dict]:
        """Commit-plane counters (stage outcomes, rollbacks, canary
        probes/mismatches, LKG generation/age) — None without a plane."""
        return None

    # -- continuous audit surface (datapath/audit.py; both engines override
    # via the AuditableDatapath mixin — inert default for test doubles) ------

    def audit_stats(self) -> Optional[dict]:
        """Audit-plane counters (cursor coverage, divergences, scrub
        outcomes, repairs) — None without a plane."""
        return None

    # -- unified maintenance surface (datapath/maintenance.py; both engines
    # override via the MaintainableDatapath mixin — inert default for test
    # doubles without a scheduler) ------------------------------------------

    def maintenance_stats(self) -> Optional[dict]:
        """Maintenance-scheduler counters (per-task runs/budget-spent/
        deferrals/shed, scheduler lag) — None without a scheduler."""
        return None

    def maintenance_force_audit(self, now: int = 0) -> Optional[dict]:
        """Operator-forced full audit sweep (the agent API's /audit
        ?force=1 path).  Engines override via the MaintainableDatapath
        mixin, which serializes the sweep through the scheduler; this
        default serves audit-capable datapaths WITHOUT a scheduler by a
        direct sweep (nothing to serialize against), and returns None
        without an audit plane."""
        if self.audit_stats() is None:
            return None
        return self.audit_scan(now, full=True)

    # -- observability plane (flight recorder + realization tracing;
    # both engines construct the objects in their constructors — these are
    # the inert defaults for test doubles without the plane) -----------------

    _flightrec = None  # observability/flightrec.FlightRecorder
    _realization = None  # observability/tracing.RealizationTracer

    def _init_observability(self, flightrec_slots: int,
                            realization_slots: int) -> None:
        """Constructor hook (both engines, before the commit plane):
        build the flight recorder + realization tracer.  Zero slots
        disable the respective surface — both are host-side only, so
        disabling changes no compiled step HLO."""
        if flightrec_slots < 0 or realization_slots < 0:
            from ..config import ConfigError

            raise ConfigError(
                f"flightrec_slots/realization_slots must be >= 0, got "
                f"{flightrec_slots}/{realization_slots}")
        from ..observability.flightrec import FlightRecorder
        from ..observability.tracing import RealizationTracer

        self._flightrec = (FlightRecorder(capacity=flightrec_slots)
                           if flightrec_slots else None)
        self._realization = (
            RealizationTracer(span_slots=realization_slots,
                              recorder=self._flightrec)
            if realization_slots else None)

    @property
    def realization_tracer(self):
        """The realization-span tracer (None when tracing is disabled):
        the agent controller, commit plane and step latch stamp spans
        through this one object."""
        return self._realization

    def realization_stats(self) -> Optional[dict]:
        """Span-table occupancy + drop meters for the metrics/API planes
        — None when tracing is disabled."""
        return None if self._realization is None else self._realization.stats()

    def flightrecorder_stats(self) -> Optional[dict]:
        """Ring-journal counters (seq head, drops, per-kind volumes) —
        None when the datapath has no recorder."""
        return None if self._flightrec is None else self._flightrec.stats()

    def flightrecorder_events(self, tail: Optional[int] = None,
                              kind: Optional[str] = None) -> list[dict]:
        """Journal contents in sequence order (the post-mortem read path:
        GET /flightrecorder, antctl, support bundle)."""
        return ([] if self._flightrec is None
                else self._flightrec.events(tail=tail, kind=kind))

    # -- hot-path telemetry (observability/telemetry.py) --------------------
    # Engines with telemetry=True build a TelemetryPlane at construction
    # and call _telemetry_account from _step + observe_step from the
    # step's timing bracket; instances built without the knob keep
    # _telemetry = None and every accessor inert.

    _telemetry = None

    @property
    def telemetry_plane(self):
        """The hot-path telemetry accumulator (None when the datapath was
        built with telemetry=False): in-kernel counter totals, per-regime
        step histograms and the sentinel's window/baseline state."""
        return self._telemetry

    def telemetry_stats(self) -> Optional[dict]:
        """Counter totals + regime latency summaries + sentinel state —
        the payload GET /telemetry, antctl and the support bundle serve.
        None when telemetry is off."""
        return None if self._telemetry is None else self._telemetry.stats()

    def _shed_total(self) -> int:
        """Cumulative lanes the async admission plane has shed (early
        drops + per-source buckets + queue overflows) — the attack-shed
        classification input.  0 on synchronous instances (they classify
        every miss in-line; nothing sheds)."""
        eng = self._slowpath
        if eng is None:
            return 0
        return int(eng.early_drops_total + eng.source_limited_total
                   + eng.queue.overflows_total)

    def _telemetry_account(self, o: dict, batch_size: int) -> Optional[str]:
        """Fold one step's telemetry: counter outputs, then classify the
        batch into its regime (from the batch's OWN outputs — n_miss plus
        sheds attributable to this batch) and queue the engine/tenant
        scope notes for the timing bracket to fold.  Returns the regime
        (the mesh extends with per-replica notes) or None when off."""
        tp = self._telemetry
        if tp is None:
            return None
        from ..observability.telemetry import classify_regime

        tp.account(o)
        shed = tp.note_shed(self._shed_total())
        n_miss = int(np.asarray(o["n_miss"]).sum())
        regime = classify_regime(batch_size, n_miss, shed)
        tp.note_regime("engine", regime)
        tid = self._tenant_id()
        if tid:
            tp.note_regime(f"tenant:{tid}", regime)
        return regime

    # -- deny export plane (observability/flowexport.py) --------------------
    # Off by default; attaching a FlowExporter (or calling
    # enable_deny_export directly) arms it.  Policy-DROP verdicts and
    # shed admissions then land in a bounded drop-oldest ring the
    # exporter drains into event="deny" flow records — denied traffic is
    # visible as records, not only counters (the reference's deny
    # connection store, pkg/agent/flowexporter/connections).

    _deny = None  # DenyRing once armed

    @property
    def deny_ring(self):
        return self._deny

    def enable_deny_export(self, capacity: int = 4096):
        """Arm the deny plane (idempotent): build the bounded ring and
        hook the slow path's admission sheds into it."""
        if self._deny is None:
            from ..observability.flowexport import DenyRing

            self._deny = DenyRing(capacity)
            eng = self._slowpath
            if eng is not None:
                eng.deny_sink = self._deny_shed_record
        return self._deny

    def deny_drain(self) -> list[dict]:
        """Pop every pending deny record (FlowExporter.poll's feed)."""
        return [] if self._deny is None else self._deny.drain()

    def _deny_shed_record(self, cols: dict, mask, reason: str,
                          now: int) -> None:
        """SlowPathEngine deny sink: record the masked admission columns
        as deny events.  `reason` names which shed gate fired
        (source-limit / early-drop / queue-overflow)."""
        from ..utils import ip as iputil

        ring = self._deny
        if ring is None:
            return
        src = np.asarray(cols["src_ip"])
        dst = np.asarray(cols["dst_ip"])
        sport = np.asarray(cols["src_port"])
        dport = np.asarray(cols["dst_port"])
        proto = np.asarray(cols["proto"])
        for i in np.nonzero(np.asarray(mask, bool))[0]:
            ring.record({
                "src": iputil.u32_to_ip(int(src[i]) & 0xFFFFFFFF),
                "dst": iputil.u32_to_ip(int(dst[i]) & 0xFFFFFFFF),
                "sport": int(sport[i]), "dport": int(dport[i]),
                "proto": int(proto[i]), "reply": False,
                "reason": reason, "at": int(now),
            })

    def _deny_verdicts(self, batch: PacketBatch, code, pending,
                       now: int) -> None:
        """Record this step's policy-DROP lanes (reason="policy").
        Pending lanes are excluded: their DROP is the hold-admission's
        PROVISIONAL verdict, not a policy decision — if the drain
        classifies the flow DROP, its next packet records here as a
        cache-hit drop."""
        ring = self._deny
        if ring is None:
            return
        from ..compiler.compile import ACT_DROP
        from ..utils import ip as iputil

        mask = np.asarray(code) == ACT_DROP
        if pending is not None:
            mask &= np.asarray(pending) == 0
        for i in np.nonzero(mask)[0]:
            ring.record({
                "src": iputil.u32_to_ip(int(batch.src_ip[i])),
                "dst": iputil.u32_to_ip(int(batch.dst_ip[i])),
                "sport": int(batch.src_port[i]),
                "dport": int(batch.dst_port[i]),
                "proto": int(batch.proto[i]), "reply": False,
                "reason": "policy", "at": int(now),
            })

    # -- async slow-path surface (datapath/slowpath; both engines) ----------
    # Shared plumbing: each engine implements the CLASSIFY callbacks
    # (_drain_classify/_epoch_revalidate/_epoch_age_scan) and calls
    # _init_slowpath from its constructor; queue admission, drain
    # orchestration, dumps and stats live here once so the two twins
    # cannot drift on the observability surface.  Synchronous instances
    # keep _slowpath = None and the inert defaults.

    _slowpath = None  # the SlowPathEngine of async instances
    _async = False
    _overlap = False  # two-slot deferred drain commits (overlap_commits)

    def _init_slowpath(self, async_slowpath: bool, dual_stack: bool,
                       miss_queue_slots: int, admission: str,
                       drain_batch: int, autotune_drain: bool = False,
                       autotune_bounds=None,
                       overlap_commits: bool = False,
                       miss_source_rate=None,
                       miss_source_burst=None) -> None:
        """Constructor hook: validate + build the engine (async mode is
        v4-only for now, like profile() probes — the queue columns are
        narrow).  autotune_drain replaces the fixed drain_batch with the
        queue-pressure hysteresis controller (drain_batch seeds the
        starting rung); overlap_commits enables the two-slot deferred
        drain-commit staging (the double-buffered churn datapath);
        miss_source_rate/_burst arm the per-source-/24 admission token
        buckets (datapath/slowpath — the reference's per-category
        rate-limited packet-in dispatchers, applied per source prefix)."""
        from ..config import ConfigError

        if async_slowpath and dual_stack:
            raise ConfigError(
                "async slow-path mode is v4-only; dual-stack instances "
                "use the synchronous slow path"
            )
        if (overlap_commits or autotune_drain) and not async_slowpath:
            raise ConfigError(
                "overlap_commits/autotune_drain configure the async "
                "slow-path engine; pass async_slowpath=True (a "
                "synchronous datapath has no drain pipeline to overlap "
                "or retune)"
            )
        if (miss_source_rate is not None or miss_source_burst is not None):
            if not async_slowpath:
                raise ConfigError(
                    "miss_source_rate/_burst configure the async "
                    "slow-path admission; pass async_slowpath=True (the "
                    "synchronous walk classifies every miss in-line, "
                    "there is no admission to rate-limit)")
            if miss_source_rate is None or miss_source_rate <= 0:
                raise ConfigError(
                    f"miss_source_rate must be a positive tokens/second "
                    f"rate, got {miss_source_rate!r}")
            if miss_source_burst is not None and miss_source_burst <= 0:
                raise ConfigError(
                    f"miss_source_burst must be positive, got "
                    f"{miss_source_burst!r}")
        self._async = async_slowpath
        self._overlap = bool(overlap_commits)
        if async_slowpath:
            self._slowpath = self._make_slowpath(
                capacity=miss_queue_slots, admission=admission,
                drain_batch=drain_batch, autotune=autotune_drain,
                autotune_bounds=autotune_bounds,
                overlap_commits=overlap_commits,
                source_rate=miss_source_rate,
                source_burst=miss_source_burst,
            )

    def _make_slowpath(self, **kw):
        """Engine factory hook: the mesh datapath overrides this to build
        its per-replica MeshSlowPath instead (parallel/meshpath.py), so
        exactly ONE engine is ever constructed per datapath."""
        from .slowpath import SlowPathEngine

        return SlowPathEngine(self, **kw)

    @staticmethod
    def _queue_cols(batch: PacketBatch, flags, lens, tenant: int = 0) -> dict:
        """The miss queue's admission columns from a stepped batch (one
        schema for both engines — MissQueue.COLUMNS sans epoch/enq_ts).
        `tenant` rides every row (0 = the default world) so drains
        classify each queued miss in its owner's policy world — the
        tenant id joins the queue exactly as it joins the slot/affinity/
        shard hashes (datapath/tenancy.py; analysis pass `tenant` fails
        the build if an admit path drops it)."""
        return {
            "src_ip": batch.src_ip.astype(np.int64),
            "dst_ip": batch.dst_ip.astype(np.int64),
            "proto": batch.proto.astype(np.int64),
            "src_port": batch.src_port.astype(np.int64),
            "dst_port": batch.dst_port.astype(np.int64),
            "flags": np.asarray(flags).astype(np.int64),
            "lens": np.asarray(lens).astype(np.int64),
            "tenant": np.full(batch.size, int(tenant), np.int64),
        }

    def drain_slowpath(self, now: int, max_batches: Optional[int] = None) -> dict:
        """Classify queued misses in coalesced batches and publish the new
        cache epoch -> stats dict (drained/batches/revalidated/...)."""
        if self._slowpath is None:
            raise RuntimeError(
                f"{type(self).__name__} was built without the async "
                f"slow-path engine (async_slowpath=False): misses classify "
                f"inline and there is nothing to drain"
            )
        return self._slowpath.drain(now, max_batches)

    def dump_miss_queue(self) -> list[dict]:
        """Queued (not-yet-classified) miss-queue rows, FIFO order — the
        queued-state half of the conntrack dump.  Empty when synchronous."""
        if self._slowpath is None:
            return []
        from ..utils import ip as iputil

        return [
            {
                "src": iputil.u32_to_ip(r["src_ip"]),
                "dst": iputil.u32_to_ip(r["dst_ip"]),
                "proto": r["proto"],
                "sport": r["src_port"],
                "dport": r["dst_port"],
                "epoch": r["epoch"],
                "enqueued_at": r["enq_ts"],
            }
            for r in self._slowpath.queue.dump()
        ]

    def flush_slowpath(self) -> int:
        """Retire every staged (deferred) overlapped drain commit ->
        number retired (0 when synchronous or nothing staged).  The state
        itself published at dispatch time; flushing settles only the
        deferred OBSERVATION (rule metrics, eviction counters)."""
        if self._slowpath is None:
            return 0
        return self._slowpath.flush_commits()

    def slowpath_stats(self) -> Optional[dict]:
        """Engine/queue/epoch counters for the metrics plane (None when
        synchronous)."""
        return None if self._slowpath is None else self._slowpath.stats()

    def profile(self, batch: PacketBatch, fresh: Optional[PacketBatch] = None,
                **kw) -> dict:
        """Phase-timed churn-loop breakdown (the profiling plane; see
        models/profile.py): run `batch` as the established hot set with a
        rolling fresh-flow window drawn from `fresh`, and return
        {"phases_s": {phase: seconds}, "total_s", "pps", ...}.  Phase
        names are implementation-defined (the tpuflow kernel reports the
        six-phase device chain; the oracle a coarse host-timed split).
        Observable state is left untouched — profiling steps run on a
        scratch copy."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement profile()"
        )


@dataclass
class DatapathStats:
    """Cumulative per-rule packet counts since datapath creation.

    Keyed by stable rule id; counts include both fresh classifications and
    cached-entry hits (ct_label attribution persists across the cache, as in
    the reference).  default_allow / default_deny count packets decided by
    no explicit rule (table-miss allow / K8s isolation deny).
    """

    ingress: dict
    egress: dict
    # Per-rule BYTE volumes (PacketBatch.pkt_len sums; the NetworkPolicy
    # stats bytes counters, ref pkg/apis/stats) — empty when batches carry
    # no lengths.
    ingress_bytes: dict = None
    egress_bytes: dict = None
    default_allow: int = 0
    default_deny: int = 0
