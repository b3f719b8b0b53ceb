"""Continuous flow-cache revalidator: audit-and-repair for stateful state.

The reference datapath's correctness under churn rests on its OVS
*revalidator* threads (ofproto/ofproto-dpif-upcall.c in the OVS the
reference binds to): the kernel megaflow cache is continuously re-proved
against the current OpenFlow tables and stale or corrupt entries are
deleted rather than trusted.  The commit plane gave this build the
install-time half of that guarantee — canaries certify every candidate
bundle on FRESH 5-tuples — but fresh probes deliberately never touch the
stateful half of the datapath, so a wrong CACHED verdict (revalidation
bug, epoch-swap race, silent device-memory corruption) was served
indefinitely and was invisible to every canary.  This plane closes that
blind spot; it runs OFF the hot step, like `canary_scan` and `age_scan`.

Three mechanisms, one plane:

  1. cache revalidation scan — each `audit_scan` samples a rotating cursor
     window of live flow-cache entries, reconstructs their 5-tuples,
     re-classifies them through the engine's fresh-walk path (tpuflow: the
     EAGER `_pipeline_trace` machinery the canary uses, so no XLA
     recompile; oracle: `fresh_walk`) and diffs cached verdict, rule
     attribution and service selection.  Conntrack-committed (eternal-gen)
     entries legitimately outlive policy changes, so they are checked
     against the structural invariants instead (a committed or reply entry
     MUST cache ALLOW; a generation-tagged entry must NOT) — a verdict-bit
     flip is detectable on every entry class without ever evicting a
     legitimately-surviving established flow.  Divergent rows are repaired
     by eviction + lazy reclassify (`models/pipeline.audit_evict`, the
     mark_stale discipline) — the cached value is never trusted.

  2. device-tensor checksum scrub — a cheap jitted XOR/sum fold
     (`models/pipeline.tensor_digest`) of every mutable device tensor
     (DeviceRuleSet incl. the delta table, service tables, forwarding
     tables, PipelineState) compared against host-side golden digests
     maintained at commit/settle time (datapath/commit.py calls
     `_audit_refresh_golden`).  Rule-side corruption self-heals by
     re-upload from the host mirror (`_audit_reupload` — cps/services/
     topology recompile-free tensor rebuilds); state-side tensors mutate
     with traffic, so their digest is pinned to the engine's accounted
     mutation counter — an unchanged counter with a changed digest is
     silent corruption, healed by a forced FULL-cache revalidation sweep.

  3. divergence policy — isolated divergences repair silently with
     metrics; a per-scan divergence count at or above `divergence_trip`
     feeds the commit plane's degraded-mode machinery (degrade + immediate
     canary-gated full recompile, paced further by the agent's existing
     install backoff), so both engines and the commit-plane watchdog share
     one escalation ladder.

Owner contract (duck-typed; both engines implement it):

  owner._audit_slots() -> int                  flow-cache slot count
  owner._audit_window(cursor, k, now) -> rows  decode k consecutive slots;
                                               LIVE entries only (see the
                                               row schema in _check_rows)
  owner._audit_fresh(rows, now) -> results     fresh-walk re-proof per row
  owner._audit_evict(slots)                    clear rows -> lazy reclassify
  owner._audit_rule_digests() -> {name: int}   rule-side tensor digests
  owner._audit_state_digest() -> int           state-side digest
  owner._audit_reupload()                      rebuild rule-side tensors
                                               from the host mirror
  owner._audit_corrupt(kind, now=None) -> str  chaos-tier injection (site
                                               f"{name}.cache"; now scopes
                                               the victim to fully-live
                                               rows the window will decode)
  owner._state_mutations                       accounted-mutation counter
  owner._commit                                the commit plane (escalation)

Fault sites (dissemination/faults.py, auto-armed by FlakyDatapath):
  f"{name}.cache"  REALLY corrupts state before the scan runs — kind
                   "partial" flips one rule-side tensor word (the
                   canary-blind service-table case), any other kind flips
                   a sampled cached verdict bit; the scan must then detect
                   and repair its own injection.
  f"{name}.audit"  forces a false-positive divergence finding (policy-path
                   exercise; nothing is evicted for it).

Observability: `audit_stats()` (scraped as
antrea_tpu_cache_audit_scans_total, antrea_tpu_cache_audit_entries_total,
antrea_tpu_cache_audit_divergences_total{kind},
antrea_tpu_cache_audit_repairs_total, antrea_tpu_tensor_scrub_total
{outcome}, antrea_tpu_audit_cursor_coverage_ratio) and the agent API's
GET /audit route (`antctl audit --server URL [--force]`).

tools/check_audit_plane.py (tier-1, wired like check_commit_plane.py)
asserts every mutable device tensor named in `_commit_snapshot` is covered
by SCRUB_MANIFEST below or explicitly waived in SCRUB_ALLOWLIST with a
reason — state added by a future PR fails the build until it is scrubbed
or waived.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

from ..compiler.compile import ACT_ALLOW

# Checksum-scrub coverage manifest: _commit_snapshot key -> tensor class.
# "rule" tensors are immutable between commits (golden digest at settle,
# self-heal by host-mirror re-upload); "state" tensors mutate with traffic
# (digest pinned to the accounted-mutation counter, self-heal by forced
# full-cache revalidation).  "dft" is scrubbed too although topology lives
# outside the commit snapshot (install_topology refreshes its golden).
# Pure literals: tools/check_audit_plane.py parses them dependency-free.
SCRUB_MANIFEST = {
    "drs": "rule",
    "dsvc": "rule",
    "dft": "rule",
    "state": "state",
}

# SUB-tensor coverage notes: leaves that ride inside a manifest group's
# digest (tree_leaves covers every leaf) but whose failure mode deserves
# an explicit, GATED record.  Deliberately NOT manifest rows — the
# maintenance scheduler prices the scrub task at len(SCRUB_MANIFEST)
# digest groups, and these are not extra folds.  Pure literal for
# tools/check_audit_plane.py, which gates each entry against the field
# that motivates it (a dropped field must drop its row and vice versa).
SCRUB_SUBTENSORS = {
    # Round-7 aggregate tables (ops/match.DimTable.agg): a corrupt
    # aggregate bit can silently FLIP a verdict (a CLEARED bit is a
    # false negative the pruned kernel's exactness argument forbids), so
    # table/aggregate divergence must stay a scrub finding — it rides
    # the `drs` digest and heals by the same host-mirror re-upload
    # (_audit_reupload rebuilds agg via _place_rules).
    "drs.agg": "rule",
}

# _commit_snapshot keys that are NOT device tensors, each with the reason
# it needs no scrub.  A new snapshot key in neither table fails
# tools/check_audit_plane.py.
SCRUB_ALLOWLIST = {
    "gen": "host int; journaled by the settle stage (cookie round)",
    "ps": "host spec object; a re-upload SOURCE, not device state",
    "ps_members": "host membership bookkeeping, no device residency",
    "services": "host spec list; the service-table re-upload source",
    "cps": "host compiled policy set; the drs re-upload source",
    "rules": "oracle twin's host interpreter; rebuilt from ps on heal",
    "o_services": "oracle twin's host program tables; rebuilt on heal",
    "flow": "oracle twin's host flow dict; covered as 'state' digest",
    "aff": "oracle twin's host affinity dict; covered as 'state' digest",
    "scrub_log": "rollback bookkeeping local to one transaction",
    "l7_ids": "host index derived from ps",
    "exemplars": "host membership bookkeeping, no device residency",
    "meta": "static trace-time constants (PipelineMeta), not a tensor",
    "meta_step": "static meta variant (see meta)",
    "has_named_ports": "host bool derived from ps",
    "n_deltas": "host int mirrored alongside delta_host",
    "delta_host": "host numpy mirror; the ip_delta re-upload source",
    "name_gids": "host index derived from cps",
    "gid_ident": "host index derived from cps",
    "group_members": "host membership mirror",
    "touched": "delta-scope bookkeeping, host-only",
    "static_blocks": "host membership mirror",
    "member_meta": "host membership mirror",
}


class AuditPlane:
    """Per-datapath revalidator state machine: cursor, digests, findings."""

    def __init__(self, owner, *, window: int = 64, divergence_trip: int = 8):
        if window <= 0:
            raise ValueError(f"audit window must be positive, got {window}")
        self.owner = owner
        self.window = int(window)
        # Divergences in ONE scan at/above this trip the commit plane's
        # degraded-mode escalation; below it, repairs are silent + metrics.
        self.divergence_trip = int(divergence_trip)
        self.cursor = 0
        self.scans_total = 0
        self.sweeps_total = 0  # completed full passes over the slot space
        self.entries_total = 0  # live entries audited
        self.repairs_total = 0  # divergent entries evicted
        self.divergences: Counter = Counter()  # kind -> count
        self.scrubs: Counter = Counter()  # outcome -> count
        self.last_divergence = ""
        self._sweep_pos = 0  # slots covered in the current sweep
        self._golden: Optional[dict] = None  # rule-side golden digests
        self._state_ref: Optional[tuple] = None  # (digest, mutation count)
        self._plan = None
        self._site = ""

    # -- fault injection (dissemination/faults.py sites) ---------------------

    def arm_faults(self, plan, name: str) -> None:
        """Consult `plan` at sites f"{name}.cache" (real injected
        corruption) and f"{name}.audit" (forced false positive) on every
        scan — the chaos tier's deterministic corruption trigger.  The
        plan journals every firing into the owner's flight recorder, so
        a chaos post-mortem reads cause beside effect."""
        self._plan = plan
        self._site = name
        plan.bind_recorder(getattr(self.owner, "_flightrec", None))

    def _emit(self, kind: str, **fields) -> None:
        from ..observability.flightrec import emit_into

        emit_into(self.owner, kind, **fields)

    # -- golden digests (commit/settle-time anchors) -------------------------

    def refresh_golden(self) -> None:
        """Re-anchor the rule-side golden digests and the state digest on
        the CURRENT tensors — called by the commit plane's settle and
        rollback paths (the tensors just changed legitimately), by
        install_topology, and at plane construction (boot tensors)."""
        o = self.owner
        self._golden = o._audit_rule_digests()
        self._state_ref = (o._audit_state_digest(), int(o._state_mutations))

    # -- the scan -------------------------------------------------------------

    def _scrub(self, out: dict) -> bool:
        """Mechanism 2: the checksum scrub.  -> True when ANY corruption
        was found (the caller then forces a full-cache revalidation)."""
        o = self.owner
        corrupt = False
        cur = o._audit_rule_digests()
        if self._golden is None or set(self._golden) != set(cur):
            # First anchor (or a tensor-set change the settle hook missed):
            # scrubbing starts from the next scan.
            self._golden = cur
            self.scrubs["clean"] += len(cur)
        else:
            bad = sorted(n for n, d in cur.items() if d != self._golden[n])
            self.scrubs["clean"] += len(cur) - len(bad)
            if bad:
                corrupt = True
                self.scrubs["corrupt"] += len(bad)
                self.divergences["scrub"] += len(bad)
                self.last_divergence = (
                    f"tensor scrub: {', '.join(bad)} diverged from the "
                    f"golden digest"
                )
                self._emit("audit-finding", source="scrub", tensors=bad)
                # Self-heal: rebuild from the host mirror — no recompile.
                o._audit_reupload()
                self._golden = o._audit_rule_digests()
                self.scrubs["healed"] += len(bad)
                out["healed"] = bad
                self._emit("audit-repair", source="scrub", tensors=bad)
        # State-side: the digest is pinned to the accounted-mutation
        # counter — an unchanged counter with a changed digest is silent
        # corruption (every legitimate write path counts itself).
        muts = int(o._state_mutations)
        digest = o._audit_state_digest()
        if (self._state_ref is not None and self._state_ref[1] == muts
                and self._state_ref[0] != digest):
            corrupt = True
            self.scrubs["corrupt"] += 1
            self.divergences["scrub"] += 1
            self.last_divergence = (
                "state tensors diverged from their digest with no "
                "accounted mutation; forcing full-cache revalidation"
            )
            out["state_corrupt"] = True
            self._emit("audit-finding", source="scrub", tensors=["state"])
        else:
            self.scrubs["clean"] += 1
        self._state_ref = (digest, muts)
        return corrupt

    def _check_rows(self, entries: list, now: int) -> list:
        """Mechanism 1 row checks -> [(slot, kind, description)].

        Row schema (both engines decode to it): slot, src/dst (combined
        keyspace ints), proto, sport, dport, code, svc (LB-program idx),
        dnat_ip, dnat_port, rule_in/rule_out (stable rule-id strings or
        None), committed (eternal generation), reply (reverse-tuple leg),
        aff (the cached program has session affinity enabled).

        Committed/reply entries legitimately outlive policy changes, so
        they are held to the structural invariant only (ALLOW is the only
        verdict the commit path ever makes eternal); generation-tagged
        entries were classified under the CURRENT bundle (any bundle or
        delta bumps the generation) and must re-prove exactly.  One
        carve-out: a divergent AFFINITY-bearing row may merely reflect an
        affinity entry that expired or was overwritten since insert (the
        fresh walk reads the CURRENT affinity table) — it is still
        repaired (eviction reconverges it to the current affinity view,
        always safe) but reported as kind "affinity", which the
        divergence policy excludes from the degrade trip.
        """
        o = self.owner
        findings: list[tuple[int, str, str]] = []
        denials = [
            e for e in entries
            if not (e["committed"] or e["reply"]) and e["code"] != ACT_ALLOW
        ]
        fresh = o._audit_fresh(denials, now) if denials else []
        fresh_by_slot = {e["slot"]: f for e, f in zip(denials, fresh)}
        for e in entries:
            if e["committed"] or e["reply"]:
                if e["code"] != ACT_ALLOW:
                    findings.append((e["slot"], "verdict",
                                     f"committed entry slot {e['slot']} "
                                     f"caches code {e['code']} (invariant: "
                                     f"eternal-generation entries are "
                                     f"ALLOW)"))
                continue
            if e["code"] == ACT_ALLOW:
                findings.append((e["slot"], "verdict",
                                 f"generation-tagged entry slot {e['slot']} "
                                 f"caches ALLOW (invariant: ALLOW commits "
                                 f"are eternal)"))
                continue
            f = fresh_by_slot[e["slot"]]
            if f["code"] != e["code"]:
                kind, what = "verdict", f"code {e['code']} vs {f['code']}"
            elif (f["rule_in"], f["rule_out"]) != (e["rule_in"],
                                                   e["rule_out"]):
                kind, what = "attribution", (
                    f"rules {(e['rule_in'], e['rule_out'])} vs "
                    f"{(f['rule_in'], f['rule_out'])}")
            elif (f["svc"], f["dnat_ip"], f["dnat_port"]) != (
                    e["svc"], e["dnat_ip"], e["dnat_port"]):
                kind, what = "service", (
                    f"svc/dnat {(e['svc'], e['dnat_ip'], e['dnat_port'])} "
                    f"vs {(f['svc'], f['dnat_ip'], f['dnat_port'])}")
            else:
                continue
            if e.get("aff"):
                kind = "affinity"  # plausible drift, not proven corruption
            findings.append((e["slot"], kind,
                             f"slot {e['slot']}: cached {what} on fresh "
                             f"re-proof"))
        return findings

    def scan(self, now: int = 0, full: bool = False, *,
             rows: Optional[int] = None, scrub: bool = True) -> dict:
        """One audit step: scripted injection -> tensor scrub -> cursor
        (or full) cache revalidation -> repair -> divergence policy.

        The maintenance scheduler (datapath/maintenance.py) budgets the
        two mechanisms as separate tasks: `rows` clamps the cursor window
        (rows=0 skips the cache walk entirely — no cursor movement, no
        sweep accounting), `scrub=False` skips the checksum scrub.  The
        default call (rows=None, scrub=True) is the historical full step
        the /audit?force=1 path and the chaos tier drive."""
        o = self.owner
        self.scans_total += 1
        out = {"scanned": 0, "audited": 0, "divergences": 0, "repaired": 0,
               "recovered": False}
        corrupt = False
        if scrub:
            # Scripted corruption (chaos site {name}.cache): REAL damage
            # the rest of this very scan must detect and repair.
            if self._plan is not None:
                rule = self._plan.fire(f"{self._site}.cache")
                if rule is not None and rule.kind != "delay":
                    out["injected_corruption"] = o._audit_corrupt(
                        "tensor" if rule.kind == "partial" else "verdict",
                        now=now)
            corrupt = self._scrub(out)
            out["scrubbed"] = len(self._golden or {}) + 1
        state_corrupt = bool(out.get("state_corrupt"))
        full = bool(full or corrupt)
        out["full"] = full

        slots = int(o._audit_slots())
        k = slots if full else min(
            self.window if rows is None else max(0, int(rows)), slots)
        if k == 0 and not full:
            # Scrub-only step (a clean scrub, else `corrupt` forced the
            # full sweep): the cursor mechanism did not run.  Scrub
            # findings surface via stats()/"healed", like every scan.
            return out
        start = 0 if full else self.cursor
        entries = o._audit_window(start, k, now)
        if full:
            self.cursor = 0
            self._sweep_pos = 0
            self.sweeps_total += 1
        else:
            self.cursor = (self.cursor + k) % slots
            self._sweep_pos += k
            if self._sweep_pos >= slots:
                self.sweeps_total += 1
                self._sweep_pos = 0
        out["scanned"] = k
        out["audited"] = len(entries)
        self.entries_total += len(entries)

        findings = self._check_rows(entries, now)
        # Forced false positive (chaos site {name}.audit): exercises the
        # divergence policy without damaging anything; never evicted.
        n_injected = 0
        if self._plan is not None:
            rule = self._plan.fire(f"{self._site}.audit")
            if rule is not None and rule.kind != "delay":
                n_injected = 1
                self.divergences["injected"] += 1
                self.last_divergence = (
                    f"injected false positive on {self._site}.audit")
        for _slot, kind, desc in findings:
            self.divergences[kind] += 1
            self.last_divergence = desc
        out["divergences"] = len(findings) + n_injected
        if findings or n_injected:
            self._emit("audit-finding", source="rows",
                       rows=len(findings), injected=n_injected,
                       kinds=sorted({k for _s, k, _d in findings}),
                       last=self.last_divergence[:200])
        # The degrade trip counts only PROVEN-corruption kinds: affinity
        # drift (see _check_rows) repairs silently with metrics, so a
        # burst of expired affinity learns can never quarantine a node.
        trip_count = n_injected + sum(
            1 for _s, kind, _d in findings if kind != "affinity")

        # Repair: evict + lazy reclassify, never trust the cached value.
        bad_slots = sorted({slot for slot, _k, _d in findings})
        if bad_slots:
            o._audit_evict(bad_slots)
            self.repairs_total += len(bad_slots)
            out["repaired"] = len(bad_slots)
            self._emit("audit-repair", source="rows", rows=len(bad_slots))
        if state_corrupt and full:
            # The forced full revalidation IS the state-side heal.
            self.scrubs["healed"] += 1
        # Re-anchor the state digest only if the state moved since the
        # scrub's own fold (repair evictions are accounted mutations) — a
        # clean scan reuses the scrub's digest instead of paying a second
        # full fold.  Un-evictable corruption (e.g. a flipped byte in a
        # dead row) stays anchored-over: reported once, not every scan.
        if int(o._state_mutations) != self._state_ref[1]:
            self._state_ref = (o._audit_state_digest(),
                               int(o._state_mutations))

        # Divergence policy: the commit plane's escalation ladder.  At/above the
        # trip, degrade and attempt an immediate full recompile (itself
        # canary-gated; while degraded the agent's sync loop keeps pacing
        # further attempts with its install backoff).
        cp = getattr(o, "_commit", None)
        if cp is not None and trip_count >= self.divergence_trip:
            if not cp.degraded:
                self._emit("degrade",
                           reason=f"audit divergence rate: {trip_count} "
                                  f"in one scan"[:200])
            cp.degraded = True
            cp.last_error = (
                f"audit divergence rate: {trip_count} in one scan "
                f"(trip={self.divergence_trip}); "
                f"last: {self.last_divergence}"
            )
            try:
                cp.run_bundle(None, None)
                out["recovered"] = True
            except Exception:  # noqa: BLE001 — still quarantined, still
                pass  # serving LKG verdicts; the agent re-drives recovery
        out["degraded"] = bool(cp is not None and cp.degraded)
        return out

    # -- observability --------------------------------------------------------

    def coverage_ratio(self) -> float:
        """Fraction of the slot space the CURRENT sweep has covered; 1.0
        right after a completed sweep, 0.0 before the first scan."""
        slots = max(1, int(self.owner._audit_slots()))
        if self._sweep_pos:
            return min(1.0, self._sweep_pos / slots)
        return 1.0 if self.sweeps_total else 0.0

    def stats(self) -> dict:
        return {
            "cursor": int(self.cursor),
            "slots": int(self.owner._audit_slots()),
            "window": int(self.window),
            "divergence_trip": int(self.divergence_trip),
            "coverage_ratio": float(self.coverage_ratio()),
            "scans_total": int(self.scans_total),
            "sweeps_total": int(self.sweeps_total),
            "entries_total": int(self.entries_total),
            "divergences": {k: int(v)
                            for k, v in sorted(self.divergences.items())},
            "divergences_total": int(sum(self.divergences.values())),
            "repairs_total": int(self.repairs_total),
            "scrub": {k: int(v) for k, v in sorted(self.scrubs.items())},
            "last_divergence": self.last_divergence,
        }


class AuditableDatapath:
    """Mixin exposing the PUBLIC audit surface on an engine.

    Engines implement the private hooks (see AuditPlane's contract) and
    call `_init_audit_plane` at the END of their constructor (after the
    commit plane, so the boot tensors anchor the golden digests)."""

    _audit: Optional[AuditPlane] = None
    # Accounted-mutation counter: every legitimate state write path bumps
    # it, so the scrub can pin the state digest between mutations.
    _state_mutations = 0

    def _init_audit_plane(self, *, audit_window: int = 64,
                          audit_divergence_trip: int = 8) -> None:
        self._audit = AuditPlane(self, window=audit_window,
                                 divergence_trip=audit_divergence_trip)
        self._audit.refresh_golden()

    @property
    def audit_plane(self) -> AuditPlane:
        return self._audit

    def audit_scan(self, now: int = 0, full: bool = False) -> dict:
        """One off-hot-step revalidator pass (AuditPlane.scan); full=True
        sweeps the whole slot space (the antctl audit --force path)."""
        return self._audit.scan(now, full=full)

    def audit_stats(self) -> dict:
        """Audit-plane counters for the metrics/API planes."""
        return self._audit.stats()

    def arm_audit_faults(self, plan, name: str) -> None:
        """Wire a FaultPlan into the scan's cache/audit sites (chaos tier)."""
        self._audit.arm_faults(plan, name)

    def _audit_refresh_golden(self) -> None:
        """Settle/rollback hook (datapath/commit.py): the tensors just
        changed legitimately — re-anchor the golden digests."""
        if self._audit is not None:
            self._audit.refresh_golden()
