"""OracleDatapath: the scalar reference implementation behind the boundary.

This is the build's stand-in for `OVSDatapathSystem` (the real-OVS datapath
the reference tests differentially against,
pkg/ovs/ovsconfig/interfaces.go:33 and the integration model
in test/integration/agent/openflow_test.go): a second, independent
implementation of the same Datapath surface, driven by the same bundles and
deltas, used to diff verdicts against tpuflow.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np

from collections import Counter

from ..apis.controlplane import GroupMember
from ..compiler.ir import PolicySet
from ..compiler.topology import (
    ARP_OP_REQUEST,
    FWD_ARP_FLOOD,
    FWD_ARP_REPLY,
    FWD_DROP_SPOOF,
    FWD_LOCAL,
    FWD_GATEWAY,
    FWD_MCAST,
    FWD_PUNT,
    FWD_TUNNEL,
    PROTO_IGMP,
    TC_REDIRECT,
    Topology,
    _tc_from_tables,
    compile_topology,
    is_mcast_u32,
    mcast_group_of,
    oracle_forward,
    oracle_spoof,
    resolve_topology,
)
from ..compiler.compile import ACT_ALLOW, ACT_DROP
from ..observability.metrics import Histogram
from ..observability.telemetry import TelemetryPlane
from ..oracle.interpreter import Oracle
from ..oracle.pipeline import PipelineOracle, _reject_kind
from ..utils import ip as iputil
from ..packet import Packet, PacketBatch
from ..config import ConfigError
from . import persist
from .audit import AuditableDatapath
from .commit import TransactionalDatapath
from .interface import Datapath, DatapathStats, DatapathType, StepResult
from .maintenance import MaintainableDatapath
from .slowpath import ADMIT_HOLD
from .tenancy import TenantedDatapath, TenantSpec


def _group_ranges(g) -> set:
    """Merged u32 range set of a group's members + static blocks — the
    compiled-visible membership (duplicate members are invisible)."""
    from ..utils import ip as iputil

    rs = [iputil.cidr_to_range(m.ip) for m in g.members]
    for b in getattr(g, "ip_blocks", []) or []:
        rs.extend(iputil.ipblock_to_ranges(b.cidr, b.excepts))
    return set(iputil.merge_ranges(rs))


class OracleDatapath(TenantedDatapath, MaintainableDatapath,
                     TransactionalDatapath, AuditableDatapath,
                     persist.PersistableDatapath, Datapath):
    # Per-world swap set of the scalar twin (datapath/tenancy; the
    # tpuflow list's scalar counterpart — analysis pass `tenant` pins the
    # required members).  The PipelineOracle object IS the world's
    # rule + state estate here.
    _TENANT_WORLD_FIELDS = (
        "_ps", "_oracle", "_gen", "_has_named_ports", "_l7_ids",
        "_exemplars", "_stats_in", "_stats_out", "_bytes_in", "_bytes_out",
        "_default_allow", "_default_deny", "_state_mutations",
        "_persist_dirty",
    )

    def __init__(
        self,
        ps: Optional[PolicySet] = None,
        services=None,
        *,
        flow_slots: int = 1 << 20,
        aff_slots: int = 1 << 18,
        ct_timeout_s: int = 3600,
        ct_syn_timeout_s=None,
        ct_other_new_s=None,
        ct_other_est_s=None,
        node_ips: Optional[list] = None,
        node_name: str = "",
        persist_dir: Optional[str] = None,
        feature_gates=None,
        topology: Optional[Topology] = None,
        dual_stack: bool = False,
        async_slowpath: bool = False,
        miss_queue_slots: int = 1 << 16,
        admission: str = "forward",
        drain_batch: int = 4096,
        autotune_drain: bool = False,
        autotune_bounds: Optional[tuple] = None,
        overlap_commits: bool = False,
        canary_probes: int = 64,
        audit_window: int = 64,
        audit_divergence_trip: Optional[int] = None,
        maint_budget: Optional[int] = None,
        maint_clock=None,
        flightrec_slots: int = 1024,
        realization_slots: int = 256,
        prune_budget: int = 0,
        autotune_prune: bool = False,
        fused: bool = False,
        second_chance: bool = False,
        telemetry: bool = False,
        miss_source_rate=None,
        miss_source_burst=None,
        serving_batcher: bool = False,
        canonical_sizes=None,
        flush_depth: Optional[int] = None,
        flush_deadline: Optional[int] = None,
        serving_ring_slots: Optional[int] = None,
    ):
        from ..features import DEFAULT_GATES

        # Same construction-time knob-combo validation as the kernel twin
        # (one typed ConfigError; see TpuflowDatapath.__init__).
        if canary_probes == 0 and audit_divergence_trip is not None:
            raise ConfigError(
                "canary_probes=0 disables the canary, but "
                "audit_divergence_trip escalation recovers through a "
                "canary-gated recompile — enable probes or drop the "
                "explicit trip"
            )
        audit_divergence_trip = (8 if audit_divergence_trip is None
                                 else audit_divergence_trip)
        # Prune knobs validated like the kernel twin's (mode-for-mode
        # construction parity for the differential harness) but otherwise
        # inert: the scalar walk has no gather volume to prune.  The
        # ladder snap under autotune mirrors the twin too, so both
        # engines REPORT the same budget for the same knobs.
        if prune_budget < 0:
            raise ConfigError(
                f"prune_budget must be >= 0, got {prune_budget}")
        if autotune_prune and prune_budget <= 0:
            raise ConfigError(
                "autotune_prune retunes the aggregate-prune K budget, but "
                "prune_budget=0 disables the aggregate layer — set an "
                "initial prune_budget (e.g. 4) to autotune from")
        # fused is inert on the scalar walk (there is no pallas kernel to
        # fuse) but validated mode-for-mode with the kernel twin so the
        # differential harness constructs both engines from one kwarg set.
        if fused and dual_stack and prune_budget > 0:
            raise ConfigError(
                "the one-kernel fast path (fused=True with prune_budget "
                "> 0) is v4-only; dual-stack instances use the staged "
                "kernel (drop fused or prune_budget, or dual_stack)")
        if autotune_prune:
            from ..ops.match import PruneAutotuner

            prune_budget = PruneAutotuner(prune_budget).budget
        self._prune_budget = int(prune_budget)
        self._fused = bool(fused)
        self._gates = feature_gates or DEFAULT_GATES
        self._dual_stack = dual_stack
        self._node_ips = list(node_ips or [])
        # Async slow path — the scalar twin of TpuflowDatapath's engine,
        # same admission/drain/epoch semantics (shared plumbing on the
        # Datapath base) so the differential harness diffs mode-for-mode;
        # the overlap/autotune knobs build the SAME engine configuration,
        # so staging depth, autotuner decisions and reclaim accounting
        # stay diffable counter-for-counter.
        self._init_slowpath(async_slowpath, dual_stack, miss_queue_slots,
                            admission, drain_batch, autotune_drain,
                            autotune_bounds, overlap_commits,
                            miss_source_rate, miss_source_burst)
        self._flow_stats = self._gates.enabled("FlowExporter")
        self._ps = ps if ps is not None else PolicySet()
        self._services = list(services or [])
        self._topo = topology
        self._gen = 0
        self._init_persist(persist_dir, ps, services)
        if self._topo is None:
            self._topo = Topology()
        self._ft = compile_topology(self._topo)
        self._rt = resolve_topology(self._topo)
        # Stashed for tenant world builds (datapath/tenancy): a tenant's
        # PipelineOracle shares every knob but the quota-rung slot counts.
        self._oracle_kw = dict(
            ct_timeout_s=ct_timeout_s,
            ct_syn_timeout_s=ct_syn_timeout_s,
            ct_other_new_s=ct_other_new_s, ct_other_est_s=ct_other_est_s,
            node_ips=list(node_ips or []), node_name=node_name,
            dual_stack=dual_stack,
            count_flow_stats=self._gates.enabled("FlowExporter"),
            second_chance=second_chance,
        )
        self._oracle = PipelineOracle(
            self._ps, self._services,
            flow_slots=flow_slots, aff_slots=aff_slots, **self._oracle_kw,
        )
        self._stats_in: Counter = Counter()
        self._stats_out: Counter = Counter()
        self._bytes_in: Counter = Counter()
        self._bytes_out: Counter = Counter()
        self._default_allow = 0
        self._default_deny = 0
        # Classify-batch latency histogram — same scrape surface as the
        # kernel twin (antrea_tpu_datapath_step_seconds).
        self.step_hist = Histogram()
        self._rebuild_l7_ids()
        # Observability plane BEFORE the commit/audit planes — same
        # contract as the kernel twin (flight recorder + span tracer).
        self._init_observability(flightrec_slots, realization_slots)
        # Hot-path telemetry accumulator — same plane as the kernel twin
        # (observability/telemetry.py), built before the maintenance
        # scheduler so the sentinel task registers.  The scalar walk has
        # no DMA half-blocks and no generation-stale probe split, so
        # those counters stay 0 here (documented divergence; hit/miss
        # and the regime histograms are twin-parity).
        if telemetry:
            self._telemetry = TelemetryPlane()
        # Commit plane LAST (datapath/commit.py): boot state is the LKG
        # baseline — same contract as the kernel twin.
        self._init_commit_plane(canary_probes=canary_probes)
        # Audit plane after the commit plane (datapath/audit.py): the boot
        # interpreter/program tables anchor the scrub's golden digests.
        self._init_audit_plane(audit_window=audit_window,
                               audit_divergence_trip=audit_divergence_trip)
        # Maintenance scheduler LAST — same task set, budgets and tick
        # semantics as the kernel twin (datapath/maintenance.py), so the
        # differential harness diffs the background plane tick-for-tick.
        self._init_maintenance(maint_budget=maint_budget,
                               maint_clock=maint_clock)
        # Tenancy plane — same contract as the kernel twin.
        self._init_tenancy()
        # Serving batcher — same admission plane as the kernel twin
        # (serving/batcher.py); lane-exact de-interleave keeps verdict
        # parity regardless of how lanes were coalesced.
        self._init_serving(serving_batcher,
                           canonical_sizes=canonical_sizes,
                           flush_depth=flush_depth,
                           flush_deadline=flush_deadline,
                           ring_slots=serving_ring_slots)

    def _rebuild_l7_ids(self) -> None:
        """Stable ids of rules carrying L7 protocols in the CURRENT policy
        set — attribution resolves against the current table, matching the
        device's post-resolve l7 gather (ct_label caveat shared).  Computed
        over the named-port-RESOLVED set so ids line up with the expanded
        rule indices both engines attribute against."""
        from ..compiler.ir import resolve_named_ports, rule_id

        rps = resolve_named_ports(self._ps)
        self._l7_ids = {
            rule_id(p, i)
            for p in rps.policies
            for i, r in enumerate(p.rules)
            if r.l7_protocols
        }
        self._has_named_ports = any(
            s.port_name
            for p in self._ps.policies for r in p.rules for s in r.services
        )
        # Exemplar member per (group, ip) so a delta re-add restores the
        # full member (node + named ports), mirroring TpuflowDatapath's
        # _member_meta bookkeeping — the twins must rebuild identical
        # membership from identical delta sequences.
        self._exemplars = {}
        for table in (self._ps.address_groups, self._ps.applied_to_groups):
            for name, g in table.items():
                ex = self._exemplars.setdefault(name, {})
                for m in g.members:
                    ex.setdefault(m.ip, m)

    # -- tenancy hooks (datapath/tenancy.TenantedDatapath) -------------------

    def _tenant_init_world(self, spec: TenantSpec, ps) -> None:
        """Scalar twin of TpuflowDatapath._tenant_init_world: a fresh
        PipelineOracle at the tenant's quota rungs, zeroed counters,
        generation 0 (no compiles — the interpreter is shape-free, so
        the rung machinery is inert here by construction)."""
        self._ps = ps
        self._gen = 0
        self._oracle = PipelineOracle(
            ps, self._services,
            flow_slots=spec.quota, aff_slots=spec.aff_quota,
            **self._oracle_kw,
        )
        self._stats_in = Counter()
        self._stats_out = Counter()
        self._bytes_in = Counter()
        self._bytes_out = Counter()
        self._default_allow = 0
        self._default_deny = 0
        self._state_mutations = 0
        self._persist_dirty = False
        self._rebuild_l7_ids()

    def _tenant_rung_sig(self) -> tuple:
        # The interpreter has no compiled shapes; the "rung" is the
        # quota pair alone (reported for symmetry with the kernel twin).
        return ("oracle", self._oracle.flow_slots, self._oracle.aff_slots)

    def _tenant_occupied(self, fields: dict) -> int:
        return len(fields["_oracle"].flow)

    def _tenant_words(self) -> int:
        return 0  # no device rule-word axis on the scalar engine

    @property
    def datapath_type(self) -> DatapathType:
        return DatapathType.ORACLE

    @property
    def generation(self) -> int:
        return self._gen

    def _install_bundle_impl(self, ps=None, services=None) -> int:
        # Compile stage of the commit plane (datapath/commit.py): the plane
        # owns canary gating, rollback, and settle-time persistence.
        if ps is not None:
            self._ps = ps
            self._rebuild_l7_ids()
        if services is not None:
            self._services = list(services)
        self._oracle.update(
            ps=ps, services=list(services) if services is not None else None,
            scrub_log=getattr(self, "_scrub_log", None),
        )
        self._state_mutations += 1  # update may scrub cached attribution
        self._gen += 1
        if self._slowpath is not None:
            self._slowpath.mark_stale(self._gen)
        return self._gen

    def _apply_group_delta_impl(self, group_name, added_ips, removed_ips) -> int:
        touched = False
        changed = False
        for table in (self._ps.address_groups, self._ps.applied_to_groups):
            g = table.get(group_name)
            if g is None:
                continue
            touched = True
            before = _group_ranges(g)
            ex = self._exemplars.get(group_name, {})
            for ip in added_ips:
                g.members.append(ex.get(ip) or GroupMember(ip=ip))
            for ip in removed_ips:
                for i, m in enumerate(g.members):
                    if m.ip == ip:
                        del g.members[i]
                        break
            if _group_ranges(g) != before:
                changed = True
        if not touched:
            raise KeyError(f"unknown group {group_name!r}")
        if self._has_named_ports:
            # Named-port synthetic membership can change even when merged
            # ranges do not (see TpuflowDatapath.apply_group_delta): every
            # delta is a full resync.
            changed = True
        if not changed:
            # Refcount-only delta (e.g. re-add of an already-present member):
            # no verdict can differ — keep the generation, matching
            # TpuflowDatapath's no-op fast path so the differential harness
            # sees identical gen/cache behavior.
            return self._gen
        self._oracle.update(ps=self._ps,
                            scrub_log=getattr(self, "_scrub_log", None))
        self._state_mutations += 1
        self._gen += 1
        if self._slowpath is not None:
            self._slowpath.mark_stale(self._gen)
        # Delta path marks dirty instead of rewriting the whole snapshot —
        # see TpuflowDatapath._apply_group_delta_impl for the recovery
        # contract; the generation is journaled by the plane's settle
        # stage (cookie-round append) after the canary certifies it.
        return self._gen

    def stats(self) -> DatapathStats:
        return DatapathStats(
            ingress=dict(self._stats_in),
            egress=dict(self._stats_out),
            ingress_bytes=dict(self._bytes_in),
            egress_bytes=dict(self._bytes_out),
            default_allow=self._default_allow,
            default_deny=self._default_deny,
        )

    def dump_flows(self, now: int) -> list[dict]:
        """Conntrack-dump analog (same record shape as TpuflowDatapath)."""
        from ..models.pipeline import GEN_ETERNAL
        from ..utils import ip as iputil

        out = []
        o = self._oracle
        gen_w = self._gen % GEN_ETERNAL
        for e in o.flow.values():
            if (now - e["ts"]) > o.timeout_of(e, e["key"][3]):
                continue
            if e["gen"] is not None and e["gen"] != gen_w:
                continue  # stale-generation denial: dead to lookups
            src, dst, pp, proto = e["key"]
            out.append({
                "src": iputil.key_to_ip(src),
                "dst": iputil.key_to_ip(dst),
                "sport": (pp >> 16) & 0xFFFF,
                "dport": pp & 0xFFFF,
                "proto": proto,
                "reply": e.get("rpl", False),
                "committed": e["gen"] is None,
                "code": e["code"],
                "svc_idx": e["svc"],
                "dnat_ip": iputil.key_to_ip(e["dnat_ip"]),
                "dnat_port": e["dnat_port"],
                "ingress_rule": e["rule_in"],
                "egress_rule": e["rule_out"],
                "last_seen": e["ts"],
                "packets": e.get("pkts", 0),
                "bytes": e.get("octets", 0),
            })
        return out

    def cache_stats(self) -> dict:
        """Flow-cache census (same keys as TpuflowDatapath.cache_stats)."""
        flow = self._oracle.flow
        committed = sum(1 for e in flow.values() if e["gen"] is None)
        return {
            "occupied": len(flow),
            "committed": committed,
            "denials": len(flow) - committed,
            "slots": self._oracle.flow_slots,
            "evictions": self._oracle.evictions,
            "reclaims": self._oracle.reclaims,
        }

    # -- async slow path (scalar twin of TpuflowDatapath's engine; shared
    # drain/dump/stats plumbing lives on the Datapath base) ------------------

    def _drain_classify(self, block: dict, now: int):
        """One popped queue block through the full scalar slow path — the
        same batch-simultaneous semantics and no-commit gating as the
        device drain step, and the point where each queued packet's real
        attribution is counted.  Drains run with reclaim=True (the fused
        eviction+aging accounting of the device's drain_reclaim meta).

        Overlapped mode: the scalar engine has no asynchronous device
        work to overlap, but it returns the SAME deferred-finalizer shape
        (state mutated now, observation counted at retire time) so the
        engine's staging depth, deferred counters and metric timing stay
        behaviorally identical to the tpuflow twin — the differential
        harness diffs the overlap semantics themselves.

        Tenant rows partition per tenant and classify inside their
        owner's world (datapath/tenancy), like the kernel twin."""
        split = self._tenant_drain_split(block)
        if split is not None:
            return self._tenant_drain_dispatch(split, now)
        from ..models.pipeline import _TEARDOWN_FLAGS, PROTO_TCP

        t0 = time.perf_counter()
        tel_tid = self._tenant_id() if self._telemetry is not None else 0
        batch = PacketBatch(
            src_ip=block["src_ip"].astype(np.uint32),
            dst_ip=block["dst_ip"].astype(np.uint32),
            proto=block["proto"].astype(np.int32),
            src_port=block["src_port"].astype(np.int32),
            dst_port=block["dst_port"].astype(np.int32),
            tcp_flags=block["flags"].astype(np.int32),
            pkt_len=block["lens"].astype(np.int32),
        )
        flags = batch.flags()
        lens = np.maximum(batch.lens(), 0)
        no_commit = [
            is_mcast_u32(batch.dst_key(i))
            or (int(batch.proto[i]) == PROTO_TCP
                and (int(flags[i]) & _TEARDOWN_FLAGS) != 0)
            for i in range(batch.size)
        ]
        outs = self._oracle.step(
            batch, now, gen=self._gen, no_commit=no_commit, flags=flags,
            lens=lens if self._flow_stats else None, reclaim=True,
        )
        self._state_mutations += 1

        def finalize():
            self._count_outcomes(outs, lens)
            if self._telemetry is not None:
                # Drains fold into the "drain" regime directly, scope
                # captured at dispatch — same contract as the kernel
                # twin's finalize.
                dt = time.perf_counter() - t0
                self._telemetry.observe_scoped("engine", "drain", dt)
                if tel_tid:
                    self._telemetry.observe_scoped(
                        f"tenant:{tel_tid}", "drain", dt)

        if self._overlap:
            return finalize
        finalize()
        return None

    def _epoch_maintain(self, now: int) -> tuple[int, int]:
        """Fused aging + stale-generation revalidation — the scalar twin
        of pl.maintain_scan's single pass, same partition (aging runs
        first, so a row both expired and stale counts as aged)."""
        aged = self._epoch_age_scan(now)
        stale = self._epoch_revalidate()
        return aged, stale

    def _epoch_revalidate(self) -> int:
        from ..models.pipeline import GEN_ETERNAL

        o = self._oracle
        gen_w = self._gen % GEN_ETERNAL
        stale = [s for s, e in o.flow.items()
                 if e["gen"] is not None and e["gen"] != gen_w]
        for s in stale:
            del o.flow[s]
        self._state_mutations += 1
        return len(stale)

    def _epoch_age_scan(self, now: int) -> int:
        o = self._oracle
        dead = [s for s, e in o.flow.items()
                if (now - e["ts"]) > o.timeout_of(e, e["key"][3])]
        for s in dead:
            del o.flow[s]
        self._state_mutations += 1
        return len(dead)

    # -- commit plane hooks (datapath/commit.py; scalar twin of the kernel's
    # snapshot/restore/canary surface) ----------------------------------------

    def _commit_snapshot(self, group: Optional[str] = None) -> dict:
        """The retained last-known-good generation.  PipelineOracle.update
        replaces its Oracle/service tables wholesale (reference copies
        suffice); its ONLY in-place flow mutation is the vanished-rule
        attribution scrub, captured copy-on-scrub via the armed
        `_scrub_log` (so the happy path never clones the cache) and
        replayed by _commit_restore.  The delta path mutates group member
        lists in place — `group` scopes that copy to the touched group
        (the twin of TpuflowDatapath's O(delta) contract)."""
        o = self._oracle
        if group is None:
            ps_members = [
                (g, list(g.members))
                for table in (self._ps.address_groups,
                              self._ps.applied_to_groups)
                for g in table.values()
            ]
        else:
            ps_members = [
                (g, list(g.members))
                for g in (self._ps.address_groups.get(group),
                          self._ps.applied_to_groups.get(group))
                if g is not None
            ]
        # Armed for the impl call this snapshot brackets: update() appends
        # (slot, rule_in, rule_out) pre-images before scrubbing.
        self._scrub_log: list = []
        return {
            "gen": self._gen,
            "ps": self._ps,
            "ps_members": ps_members,
            "services": self._services,
            "rules": o.oracle,
            "o_services": (o.services, o.programs, o.svc_by_key),
            "flow": o.flow,  # by reference; mutations ride the scrub log
            "aff": o.aff,  # neither update() nor the delta path touches it
            "scrub_log": self._scrub_log,
            "l7_ids": self._l7_ids,
            "has_named_ports": self._has_named_ports,
            "exemplars": self._exemplars,
        }

    def _commit_restore(self, snap: dict) -> None:
        o = self._oracle
        self._gen = snap["gen"]
        self._ps = snap["ps"]
        for g, members in snap["ps_members"]:
            g.members = members
        self._services = snap["services"]
        o.oracle = snap["rules"]
        o.services, o.programs, o.svc_by_key = snap["o_services"]
        o.flow = snap["flow"]
        o.aff = snap["aff"]
        for slot, ri, ro in snap["scrub_log"]:
            e = o.flow.get(slot)
            if e is not None:
                e["rule_in"], e["rule_out"] = ri, ro
        self._l7_ids = snap["l7_ids"]
        self._has_named_ports = snap["has_named_ports"]
        self._exemplars = snap["exemplars"]
        self._state_mutations += 1

    def _canary_classify(self, batch: PacketBatch, now: int) -> np.ndarray:
        """Fresh-walk verdict of each probe, state untouched (fresh_walk is
        read-only: affinity learns are returned, never applied)."""
        o = self._oracle
        return np.asarray([
            o.fresh_walk(o.aff, batch.packet(i),
                         o._flow_hash(batch.packet(i)), now)["code"]
            for i in range(batch.size)
        ], np.int32)

    # -- audit plane hooks (datapath/audit.py; scalar twin of the kernel's
    # window/fresh/scrub surface — identical semantics so tests can diff
    # the planes mode-for-mode) -----------------------------------------------

    def _audit_slots(self) -> int:
        return self._oracle.flow_slots

    @staticmethod
    def _crc(obj) -> int:
        """Deterministic host digest (zlib.crc32 over repr) — the scalar
        twin of the device XOR/sum fold; compared only within a process."""
        import zlib

        return zlib.crc32(repr(obj).encode())

    def _audit_rule_digests(self) -> dict:
        """Digests of the verdict-determining derived material — the
        scalar twin of the kernel's rule-side tensors: the interpreter's
        resolved policy set and the compiled LB program/frontend tables."""
        o = self._oracle
        ps = o.oracle.ps
        return {
            "rules": self._crc((
                ps.policies,
                sorted(ps.address_groups.items()),
                sorted(ps.applied_to_groups.items()),
            )),
            "programs": self._crc(
                (o.programs, sorted(o.svc_by_key.items()))),
        }

    def _audit_state_digest(self) -> int:
        o = self._oracle
        return self._crc((
            tuple(sorted((s, tuple(sorted(e.items())))
                         for s, e in o.flow.items())),
            tuple(sorted((s, tuple(sorted(e.items())))
                         for s, e in o.aff.items())),
        ))

    def _audit_reupload(self) -> None:
        """Rule-side self-heal: rebuild the interpreter and the LB program
        tables from the authoritative held spec (the host-mirror analog);
        flow/affinity state untouched."""
        o = self._oracle
        o.oracle = Oracle(self._ps)
        o._set_services(self._services)

    def _audit_window(self, cursor: int, k: int, now: int) -> list[dict]:
        """Decode k consecutive flow slots (full sweeps walk the dict
        directly) into the shared audit row schema; LIVE entries only,
        same liveness rule as dump_flows."""
        from ..models.pipeline import GEN_ETERNAL

        o = self._oracle
        N = o.flow_slots
        gen_w = self._gen % GEN_ETERNAL
        if k >= N:
            slots = sorted(o.flow)
        else:
            slots = [(cursor + j) % N for j in range(k)]
        rows = []
        for slot in slots:
            e = o.flow.get(slot)
            if e is None:
                continue
            if (now - e["ts"]) > o.timeout_of(e, e["key"][3]):
                continue
            if e["gen"] is not None and e["gen"] != gen_w:
                continue
            src, dst, pp, proto = e["key"]
            rows.append({
                "slot": slot,
                "src": src,
                "dst": dst,
                "proto": proto,
                "sport": (pp >> 16) & 0xFFFF,
                "dport": pp & 0xFFFF,
                "code": int(e["code"]),
                "svc": int(e["svc"]),
                "dnat_ip": int(e["dnat_ip"]),
                "dnat_port": int(e["dnat_port"]),
                "rule_in": e["rule_in"],
                "rule_out": e["rule_out"],
                "committed": e["gen"] is None,
                "reply": e.get("rpl", False),
                # Affinity-bearing program: divergence may be drift of the
                # CURRENT affinity table, not corruption (audit.py keeps
                # it outside the degrade trip) — kernel-twin semantics.
                "aff": bool(
                    0 <= e["svc"] < len(o.programs)
                    and o.programs[e["svc"]].affinity_timeout_s > 0),
            })
        return rows

    def _audit_fresh(self, rows: list, now: int) -> list[dict]:
        """Fresh-walk re-proof per audited entry (fresh_walk is read-only:
        affinity learns are returned, never applied)."""
        o = self._oracle
        out = []
        for r in rows:
            p = Packet(src_ip=r["src"], dst_ip=r["dst"], proto=r["proto"],
                       src_port=r["sport"], dst_port=r["dport"])
            w = o.fresh_walk(o.aff, p, o._flow_hash(p), now)
            no_ep = w["no_ep"]
            out.append({
                "code": int(w["code"]),
                "svc": int(w["svc_idx"]),
                "dnat_ip": int(w["dnat_ip"]),
                "dnat_port": int(w["dnat_port"]),
                # SvcReject precedes the policy tables: no attribution —
                # the same gating the commit path applied at insert.
                "rule_in": None if no_ep else w["ingress_rule"],
                "rule_out": None if no_ep else w["egress_rule"],
            })
        return out

    def _audit_evict(self, slots: list) -> None:
        for s in slots:
            self._oracle.flow.pop(s, None)
        self._state_mutations += 1

    def _audit_corrupt(self, kind: str, now: Optional[int] = None) -> str:
        """Chaos-tier injection (site f"{name}.cache") — the scalar twin
        of the kernel's corrupt hook.  kind "tensor" flips derived service
        material (the canary-blind class: probes avoid frontends); any
        other kind flips a sampled cached verdict bit.  `now` scopes the
        victim to fully-live rows (idle timeout included) so the scan can
        always detect its own injection.  The mutation counter is
        deliberately NOT bumped."""
        import dataclasses

        o = self._oracle
        if kind == "tensor":
            for pi, prog in enumerate(o.programs):
                if prog.endpoints:
                    ep = prog.endpoints[0]
                    prog.endpoints[0] = dataclasses.replace(
                        ep, port=ep.port ^ 1)
                    return f"flipped program {pi} endpoint 0 port bit 0"
            if o.svc_by_key:
                k0 = sorted(o.svc_by_key)[0]
                prog, snat = o.svc_by_key[k0]
                o.svc_by_key[k0] = (prog, snat ^ 1)
                return f"flipped frontend snat bit of {k0}"
            kind = "verdict"  # nothing service-side to flip
        # Victim must be GENERATION-LIVE (same filter as the kernel twin's
        # corrupt hook): flipping a stale-gen row the audit window skips
        # would break the chaos-site contract that the scan detects its
        # own injection.
        from ..models.pipeline import GEN_ETERNAL

        gen_w = self._gen % GEN_ETERNAL
        live = sorted(
            s for s, e in o.flow.items()
            if (e["gen"] is None or e["gen"] == gen_w)
            and (now is None
                 or (now - e["ts"]) <= o.timeout_of(e, e["key"][3]))
        )
        if not live:
            return "no live entry to corrupt"
        slot = live[0]
        o.flow[slot]["code"] ^= 1
        return f"flipped cached verdict bit of slot {slot}"

    def profile(self, batch: PacketBatch, fresh: Optional[PacketBatch] = None,
                *, now: int = 1000, mode: str = "sync", **_kw) -> dict:
        """Coarse host-timed phase split (the scalar twin of the kernel's
        six-phase device chain, TpuflowDatapath.profile): fast_path =
        cache lookup of every lane, classify = the fresh ServiceLB+
        classifier walk of the lanes that MISS (mirroring what step()
        actually pays — a warmed hot set classifies nothing), and
        commit_residual = full step minus both (the commit bookkeeping +
        output assembly).  State and counters are snapshotted and
        restored — profiling is observable-state-neutral.

        mode="async" reports the decoupled-regime names (async_fast_path /
        drain_classify / drain_commit_residual) over the same coarse
        split — on the scalar engine the fast-lookup and miss-walk costs
        ARE the fast-step and drain costs.  mode="overlap" reports the
        overlapped-regime names over the identical split: the scalar
        engine is host-sequential, so its overlap numbers ARE its async
        numbers — the honest statement that there is nothing to overlap
        here, kept mode-for-mode so harnesses can call either twin.
        mode="maintenance" additionally times one fused maintenance pass
        (_epoch_maintain, the cache-maintain task of the unified
        scheduler) as `maint_sweep` / `maintenance_s` — the scalar twin
        of MAINT_PHASE_CHAIN's rider.  mode="prune" reports the
        prune-regime names over the identical split: the scalar walk has
        no aggregate layer (its per-packet AND is already O(matched
        rules)), so its candidate-gather number IS its classify number —
        the honest twin statement, kept mode-for-mode."""
        if mode not in ("sync", "async", "overlap", "maintenance", "prune",
                        "fused", "telemetry"):
            raise ValueError(f"unknown profile mode {mode!r}")
        if mode == "prune" and self._prune_budget <= 0:
            # Twin-parity with TpuflowDatapath.profile: both engines
            # refuse the mode on an unpruned instance.
            raise ValueError(
                "profile(mode='prune') needs prune_budget > 0 "
                "(the two-level kernel is compiled out at 0)")
        if mode == "prune" and self._fused and self._prune_budget > 0:
            # Twin-parity: a one-pass-capable instance serves the fused
            # kernel — staged-prune labels would misattribute it.
            raise ValueError(
                "profile(mode='prune') attributes the STAGED pruned "
                "kernel, but this instance serves the one-pass fast "
                "path — use mode='fused' (or construct with "
                "fused=False) for an honest attribution")
        if mode == "fused" and not (self._fused and self._prune_budget > 0):
            # Twin-parity: both engines refuse the mode unless the
            # instance is one-pass-capable (fused + pruned).
            raise ValueError(
                "profile(mode='fused') needs the one-kernel fast path "
                "(construct with fused=True and prune_budget > 0)")
        from ..models.pipeline import GEN_ETERNAL

        o = self._oracle
        gen_w = self._gen % GEN_ETERNAL
        if mode == "telemetry":
            # Telemetry-counter structure check — the scalar twin of
            # TpuflowDatapath.profile(mode="telemetry"): read-only cache
            # lookups of the probe batch split into the same
            # TELEMETRY_COUNTERS keys (probe_stale / chance_bumps /
            # dma_hb stay 0: no generation-stale split, no replacement
            # counter, no DMA on the scalar walk).  State untouched.
            n_hit = 0
            for i in range(batch.size):
                p = batch.packet(i)
                _slot, e = o.lookup(o.flow, p, o._flow_hash(p), now, gen_w)
                if e is not None:
                    n_hit += 1
            return {
                "mode": "telemetry",
                "batch": batch.size,
                "counters": {
                    "probe_hit": n_hit,
                    "probe_stale": 0,
                    "probe_miss": batch.size - n_hit,
                    "chance_bumps": 0,
                    "dma_hb": 0,
                },
            }
        probes = [batch] + ([fresh] if fresh is not None else [])
        packets = [b.packet(i) for b in probes for i in range(b.size)]
        misses = []
        t0 = time.perf_counter()
        for p in packets:
            h = o._flow_hash(p)
            _slot, e = o.lookup(o.flow, p, h, now, gen_w)
            if e is None:
                misses.append(p)
        t_fast = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p in misses:
            o.fresh_walk(o.aff, p, o._flow_hash(p), now)
        t_cls = time.perf_counter() - t0
        snap = (copy.deepcopy(o.flow), copy.deepcopy(o.aff), o.evictions,
                dict(self._stats_in), dict(self._stats_out),
                dict(self._bytes_in), dict(self._bytes_out),
                self._default_allow, self._default_deny)
        hist_snap = (list(self.step_hist._counts), self.step_hist.sum,
                     self.step_hist.count)
        muts0 = self._state_mutations
        t_maint = 0.0
        try:
            t0 = time.perf_counter()
            for b in probes:
                self.step(b, now)
            total = time.perf_counter() - t0
            if mode == "maintenance":
                # The maintenance rider, inside the snapshot/restore
                # bracket like the steps: state-neutral to the caller.
                t0 = time.perf_counter()
                self._epoch_maintain(now)
                t_maint = time.perf_counter() - t0
                total += t_maint
        finally:
            (o.flow, o.aff, o.evictions, si, so, bi, bo,
             self._default_allow, self._default_deny) = (
                snap[0], snap[1], snap[2], snap[3], snap[4], snap[5],
                snap[6], snap[7], snap[8])
            self._stats_in = Counter(si)
            self._stats_out = Counter(so)
            self._bytes_in = Counter(bi)
            self._bytes_out = Counter(bo)
            (self.step_hist._counts, self.step_hist.sum,
             self.step_hist.count) = hist_snap
            self._state_mutations = muts0
        n = len(packets)
        if mode == "async":
            phases = {
                "async_fast_path": t_fast,
                "drain_classify": t_cls,
                "drain_commit_residual": max(total - t_fast - t_cls, 0.0),
            }
        elif mode == "overlap":
            phases = {
                "overlap_fast_path": t_fast,
                "overlap_classify": t_cls,
                "overlap_commit_residual": max(total - t_fast - t_cls, 0.0),
            }
        elif mode == "maintenance":
            phases = {
                "maint_fast_path": t_fast,
                "maint_classify": t_cls,
                "maint_commit_residual": max(
                    total - t_fast - t_cls - t_maint, 0.0),
                "maint_sweep": t_maint,
            }
        elif mode == "prune":
            phases = {
                "prune_fast_path": t_fast,
                "prune_candidate_gather": t_cls,
                "prune_commit_residual": max(total - t_fast - t_cls, 0.0),
            }
        elif mode == "fused":
            # The scalar walk has no kernel to fuse: its classify time IS
            # its one-pass time — the honest twin statement, mode-for-mode.
            phases = {
                "fused_fast_path": t_fast,
                "fused_onepass": t_cls,
                "fused_commit_residual": max(total - t_fast - t_cls, 0.0),
            }
        else:
            phases = {
                "fast_path": t_fast,
                "classify": t_cls,
                "commit_residual": max(total - t_fast - t_cls, 0.0),
            }
        out = {
            "batch": n,
            "fresh_per_step": 0 if fresh is None else fresh.size,
            "misses": len(misses),
            "phases_s": phases,
            "total_s": total,
            "pps": n / max(total, 1e-9),
            "phase_fractions": {k: v / max(total, 1e-9)
                                for k, v in phases.items()},
        }
        if mode == "maintenance":
            out["mode"] = "maintenance"
            out["maintenance_s"] = t_maint
            out["maintenance_fraction"] = t_maint / max(total, 1e-9)
        elif mode == "prune":
            out["mode"] = "prune"
            out["prune_budget"] = self._prune_budget
        elif mode == "fused":
            out["mode"] = "fused"
            out["prune_budget"] = self._prune_budget
        return out

    def trace(self, batch: PacketBatch, now: int) -> list[dict]:
        """Read-only per-packet trace, same semantics as TpuflowDatapath:
        the FRESH pipeline walk for every packet plus the cache overlay
        (effective `code` from the cache on hits)."""
        if not self._gates.enabled("Traceflow"):
            raise RuntimeError("Traceflow feature gate is disabled")
        from ..models.pipeline import GEN_ETERNAL

        o = self._oracle
        gen_w = self._gen % GEN_ETERNAL
        in_ports = batch.in_ports()
        out = []
        for i in range(batch.size):
            p = batch.packet(i)
            h = o._flow_hash(p)
            _slot, e = o.lookup(o.flow, p, h, now, gen_w)
            w = o.fresh_walk(o.aff, p, h, now)
            code = e["code"] if e is not None else w["code"]
            is_rpl = e is not None and e.get("rpl", False)
            # Forward-leg destination mirrors step()/_forward_fields: replies
            # route to their literal dst, non-reply HITS by the cached
            # entry's DNAT resolution, misses by the fresh walk.
            if is_rpl:
                eff_dst = p.dst_ip
            elif e is not None:
                eff_dst = e["dnat_ip"]
            else:
                eff_dst = w["dnat_ip"]
            f = oracle_forward(self._rt, eff_dst, int(in_ports[i]))
            queued = (
                self._slowpath is not None
                and self._slowpath.queue.contains(
                    int(p.src_ip), int(p.dst_ip), int(batch.proto[i]),
                    int(batch.src_port[i]), int(batch.dst_port[i]))
            )
            out.append({
                "queued": queued,
                "spoofed": oracle_spoof(self._rt, p.src_ip, int(in_ports[i])),
                "fwd_kind": f["kind"],
                "out_port": f["out_port"],
                "cache_hit": e is not None,
                "est": e is not None and e["gen"] is None,
                "reply": e is not None and e.get("rpl", False),
                "reject_kind": _reject_kind(code, p.proto),
                "snat": w["snat"],
                "dsr": w["dsr"],
                "svc_idx": w["svc_idx"],
                "no_ep": w["no_ep"],
                "dnat_ip": w["dnat_ip"],
                "dnat_port": w["dnat_port"],
                "egress_code": w["egress_code"],
                "egress_rule": w["egress_rule"],
                "ingress_code": w["ingress_code"],
                "ingress_rule": w["ingress_rule"],
                "fresh_code": w["code"],
                "code": code,
            })
        return out

    def install_topology(self, topo: Topology) -> None:
        # Compile-then-assign: a rejected topology leaves state unchanged.
        ft = compile_topology(topo)
        self._topo = topo
        self._ft = ft
        self._rt = resolve_topology(topo)
        self._persist_topology()

    def mcast_group(self, idx: int) -> Optional[dict]:
        """Resolve a StepResult.mcast_idx to its replication set (the
        MulticastOutput bucket list, ref pkg/agent/openflow/multicast.go)."""
        return mcast_group_of(self._rt, idx)

    def step(self, batch: PacketBatch, now: int, *, valid=None) -> StepResult:
        t0 = time.perf_counter()
        # Traffic time drives the maintenance tick clock (one clock
        # domain: flow-cache aging and FQDN expiry stamp with THIS now).
        self._maintenance.observe(now)
        if self._realization is not None:
            # First-hit latch (realization tracing) — the scalar twin of
            # the tpuflow step latch, so span STRUCTURE is oracle-parity.
            self._realization.first_hit(self._gen, batch.size)
        try:
            return self._step(batch, now, valid=valid)
        finally:
            dt = time.perf_counter() - t0
            self.step_hist.observe(dt)
            if self._telemetry is not None:
                self._telemetry.observe_step(dt)

    def _step(self, batch: PacketBatch, now: int, valid=None) -> StepResult:
        from ..models.pipeline import _TEARDOWN_FLAGS, PROTO_TCP

        in_ports = batch.in_ports()
        flags = batch.flags()
        arp_ops = batch.arp_ops()
        O = self._oracle
        if batch.has_v6 and not self._dual_stack:
            raise ValueError(
                "batch carries v6 lanes but this datapath is v4-only; "
                "construct it with dual_stack=True"
            )
        ext = None if valid is None else np.asarray(valid, bool)
        lane_modes = []
        no_commit = []
        for i in range(batch.size):
            if ext is not None and not ext[i]:
                # Serving-batcher padding lanes ride the spoof/skip
                # discipline (the kernel twin's valid mask): nothing
                # probed, committed, or counted.
                lane_modes.append(O.LANE_SPOOF)
            elif oracle_spoof(self._rt, batch.src_key(i), int(in_ports[i])):
                lane_modes.append(O.LANE_SPOOF)
            elif int(arp_ops[i]) > 0:
                # ARP lanes bypass the IP pipeline (handled in forwarding);
                # code ALLOW, nothing committed — the punt-lane treatment.
                lane_modes.append(O.LANE_PUNT)
            elif int(batch.proto[i]) == PROTO_IGMP:
                lane_modes.append(O.LANE_PUNT)
            else:
                lane_modes.append(O.LANE_NORMAL)
            # Multicast bypasses conntrack; a FIN/RST-flagged TCP miss
            # never establishes (the closing-segment rule — same gating as
            # models/forwarding._pipeline_step_full).
            no_commit.append(
                is_mcast_u32(batch.dst_key(i))
                or (int(batch.proto[i]) == PROTO_TCP
                    and (int(flags[i]) & _TEARDOWN_FLAGS) != 0)
            )
        lens = np.maximum(batch.lens(), 0)
        fast_only = None
        if self._async:
            fast_only = (ACT_DROP
                         if self._slowpath.admission == ADMIT_HOLD
                         else ACT_ALLOW)
        outs = self._oracle.step(
            batch, now, gen=self._gen, lane_modes=lane_modes,
            no_commit=no_commit, flags=flags,
            lens=lens if self._flow_stats else None,
            fast_only=fast_only,
        )
        self._state_mutations += 1
        if self._async:
            pend = np.array([o.pending for o in outs], bool)
            if pend.any():
                # Tenant worlds: quota-clamped admission + the tenant id
                # column, same contract as the kernel twin's admit path
                # (both are no-ops on the default world).
                admitted, _dropped = self._slowpath.admit(
                    self._queue_cols(batch, flags, lens,
                                     tenant=self._tenant_id()),
                    self._tenant_admit_mask(pend), now,
                )
                self._tenant_note_admitted(admitted, _dropped)
        if self._telemetry is not None:
            # Scalar probe split: a lane either found its flow row (hit)
            # or walked the tables (miss); the scalar cache is a dict, so
            # there is no generation-stale rejection to split out —
            # probe_stale stays 0 (documented twin divergence).  Skipped
            # lanes (SpoofGuard) probe nothing, like the kernel's
            # valid-masked lanes.
            n_miss = sum(1 for o in outs if not (o.hit or o.skipped))
            n_hit = sum(1 for o in outs if o.hit and not o.skipped)
            self._telemetry_account(
                {"n_miss": n_miss,
                 "tel_probe_hit": n_hit,
                 "tel_probe_miss": n_miss},
                batch.size)
        fwd = self._forward_fields(batch, outs, in_ports, lane_modes,
                                   arp_ops)
        self._count_outcomes(outs, lens)
        res = self._to_result(outs, fwd)
        if self._deny is not None:
            self._deny_verdicts(batch, res.code, res.pending, now)
        return res

    def _count_outcomes(self, outs, lens) -> None:
        """NetworkPolicyStats accounting shared by step() and the drain
        path — one implementation so the counted-exactly-once contract
        (skipped lanes never, pending lanes at drain time) cannot drift
        between the two."""
        if not self._gates.enabled("NetworkPolicyStats"):
            return
        for i, o in enumerate(outs):
            if o.skipped:
                continue  # SpoofGuard drop: before the policy tables
            if o.pending:
                continue  # provisional verdict: counted at drain time
            ln = int(lens[i])
            if o.ingress_rule is not None:
                self._stats_in[o.ingress_rule] += 1
                if ln:
                    self._bytes_in[o.ingress_rule] += ln
            if o.egress_rule is not None:
                self._stats_out[o.egress_rule] += 1
                if ln:
                    self._bytes_out[o.egress_rule] += ln
            if o.ingress_rule is None and o.egress_rule is None:
                if o.code == 0:
                    self._default_allow += 1
                else:
                    self._default_deny += 1

    def _forward_fields(
        self, batch: PacketBatch, outs, in_ports, lane_modes, arp_ops=None
    ) -> list[dict]:
        """Per-lane forwarding decision via the scalar spec
        (compiler/topology.oracle_forward + TC resolution), mirroring
        models/forwarding._pipeline_step_full's output gating exactly."""
        O = self._oracle
        rows = []
        for i, o in enumerate(outs):
            if lane_modes[i] == O.LANE_SPOOF:
                rows.append({"spoofed": 1, "punt": 0,
                             "fwd_kind": FWD_DROP_SPOOF,
                             "out_port": -1, "peer_ip": 0, "dec_ttl": 0,
                             "tc_act": 0, "tc_port": 0, "mcast_idx": -1})
                continue
            if arp_ops is not None and int(arp_ops[i]) > 0:
                # ARPResponder (scalar spec = ResolvedTopology.arp_u32):
                # answered requests reply out the ingress port; the rest
                # floods (OFPP_NORMAL).  Spoofed ARP was caught above.
                # v6 lanes model Neighbor Discovery (NS answers from the
                # nd set — the NDP twin, route_linux.go v6 neighbors).
                tgt = batch.dst_key(i)
                answer = (
                    int(arp_ops[i]) == ARP_OP_REQUEST
                    and (tgt in self._rt.nd_keys
                         if iputil.key_is_v6(tgt)
                         else tgt in self._rt.arp_u32)
                )
                rows.append({
                    "spoofed": 0, "punt": 0,  # answered in the dataplane
                    "fwd_kind": FWD_ARP_REPLY if answer else FWD_ARP_FLOOD,
                    "out_port": int(in_ports[i]) if answer else -1,
                    "peer_ip": 0, "dec_ttl": 0,
                    "tc_act": 0, "tc_port": 0, "mcast_idx": -1,
                })
                continue
            if lane_modes[i] == O.LANE_PUNT:
                rows.append({"spoofed": 0, "punt": 1, "fwd_kind": FWD_PUNT,
                             "out_port": -1, "peer_ip": 0, "dec_ttl": 0,
                             "tc_act": 0, "tc_port": 0, "mcast_idx": -1})
                continue
            # Replies forward to their literal dst (the client); their dnat
            # fields carry the source un-rewrite.
            eff_dst = batch.dst_key(i) if o.reply else o.dnat_ip
            f = oracle_forward(self._rt, eff_dst, int(in_ports[i]))
            deliverable = o.code == ACT_ALLOW and f["kind"] in (
                FWD_LOCAL, FWD_TUNNEL, FWD_GATEWAY, FWD_MCAST
            )
            uni_deliverable = deliverable and f["kind"] != FWD_MCAST
            if uni_deliverable:
                tc_act, tc_port = _tc_from_tables(
                    self._ft, batch.src_key(i), eff_dst
                )
            else:
                tc_act, tc_port = 0, 0
            out_port = f["out_port"] if deliverable else -1
            if tc_act == TC_REDIRECT:
                out_port = tc_port
            rows.append({
                "spoofed": 0,
                "punt": 0,
                "fwd_kind": f["kind"],
                "out_port": out_port,
                "peer_ip": f["peer_ip"] if uni_deliverable else 0,
                "dec_ttl": int(f["dec_ttl"]) if uni_deliverable else 0,
                "tc_act": tc_act,
                "tc_port": tc_port,
                "mcast_idx": f.get("mcast_idx", -1) if deliverable else -1,
            })
        return rows

    def _to_result(self, outs, fwd) -> StepResult:
        def col(key, dtype=np.int32):
            return np.array([r[key] for r in fwd], dtype)

        def narrow(v):
            # v6 combined keys don't fit the u32 lane; the dual-stack view
            # is dnat_key/peer_key (interface.py).
            return v if v < (1 << 32) else 0

        return StepResult(
            code=np.array([o.code for o in outs], np.int32),
            est=np.array([int(o.est) for o in outs], np.int32),
            pending=(np.array([int(o.pending) for o in outs], np.int32)
                     if self._async else None),
            svc_idx=np.array([o.svc_idx for o in outs], np.int32),
            dnat_ip=np.array([narrow(o.dnat_ip) for o in outs], np.uint32),
            dnat_port=np.array([o.dnat_port for o in outs], np.int32),
            ingress_rule=[o.ingress_rule for o in outs],
            egress_rule=[o.egress_rule for o in outs],
            committed=np.array([int(o.committed) for o in outs], np.int32),
            n_miss=sum(1 for o in outs if not (o.hit or o.skipped)),
            reply=np.array([int(o.reply) for o in outs], np.int32),
            reject_kind=np.array([o.reject_kind for o in outs], np.int32),
            snat=np.array([o.snat for o in outs], np.int32),
            dsr=np.array([o.dsr for o in outs], np.int32),
            spoofed=col("spoofed"),
            punt=col("punt"),
            mcast_idx=col("mcast_idx"),
            l7_redirect=np.array([
                1 if (o.code == ACT_ALLOW and not o.skipped
                      and (o.ingress_rule in self._l7_ids
                           or o.egress_rule in self._l7_ids))
                else 0
                for o in outs
            ], np.int32),
            fwd_kind=col("fwd_kind"),
            out_port=col("out_port"),
            peer_ip=np.array([narrow(r["peer_ip"]) for r in fwd], np.uint32),
            dec_ttl=col("dec_ttl"),
            tc_act=col("tc_act"),
            tc_port=col("tc_port"),
            dnat_key=([o.dnat_ip for o in outs]
                      if self._dual_stack else None),
            peer_key=([r["peer_ip"] for r in fwd]
                      if self._dual_stack else None),
        )
