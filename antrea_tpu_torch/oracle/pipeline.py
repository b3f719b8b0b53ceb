"""Scalar full-pipeline oracle: flow cache + conntrack + service LB + policy.

This is the SPEC for models/pipeline.py — same hash functions, same
direct-mapped slot discipline, same generation semantics — so parity is
exact, including eviction behavior:

  * A unified flow cache keyed by the 5-tuple caches the verdict, DNAT
    resolution and rule attribution of every classified flow (the OVS
    EMC/megaflow-cache analog; the reference's datapath performance rests on
    the same design, docs/design/ovs-pipeline.md conntrack sections).
  * ALLOW entries are conntrack commits: they persist across rule-set
    generations (the ct_state -new+est policy bypass,
    ovs-pipeline.md:1685-1691) and pin their DNAT endpoint and service
    attribution at establishment time.
  * DROP/REJECT entries are tagged with the rule generation; a bundle
    commit (gen bump) invalidates them (megaflow revalidation analog), so
    denied flows are re-evaluated against the new rules.
  * Any hit refreshes the idle timeout.

Batch semantics match the device: a batch is "simultaneous arrival" —
lookups see start-of-batch state; inserts/learns/refreshes apply afterwards
in batch order (last writer wins on slot collisions).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..apis.service import ServiceEntry
from ..apis.controlplane import PROTO_TCP
from ..compiler.compile import ACT_ALLOW, ACT_REJECT
from ..models.pipeline import (
    CHANCE_MAX,
    GEN_ETERNAL,
    REJECT_ICMP_UNREACH,
    REJECT_NONE,
    REJECT_TCP_RST,
    _TEARDOWN_FLAGS,
)
from ..compiler.ir import PolicySet
from . import hashing
from ..packet import Packet, PacketBatch
from ..utils import ip as iputil
from .interpreter import Oracle


@dataclass
class ScalarOutcome:
    code: int
    est: bool
    svc_idx: int  # -1 none (LB-program index, see compiler/services.py)
    dnat_ip: int  # raw u32; on reply hits: the UN-DNAT source rewrite
    dnat_port: int
    egress_rule: Optional[str]
    ingress_rule: Optional[str]
    committed: bool
    hit: bool = False  # flow-cache hit (False => slow-path classification)
    reply: bool = False  # reverse-tuple (reply-direction) conntrack hit
    reject_kind: int = 0  # 0 none / 1 tcp-rst / 2 icmp-port-unreachable
    snat: int = 0  # SNAT mark: external frontend under ETP=Cluster
    # DSR delivery mark (ref pipeline.go:145 DSRServiceMark): forward toward
    # the selected endpoint (dnat fields) WITHOUT rewriting the L3 dst and
    # without SNAT; no reply-direction conntrack leg is committed.
    dsr: int = 0
    # Lane excluded by the caller's lane modes (SpoofGuard drop or IGMP
    # punt): handled BEFORE the pipeline — no state touched, not a cache
    # miss either.
    skipped: bool = False
    # Async slow-path mode (datapath/slowpath): the lane missed the cache
    # and was left UNclassified — `code` is the admission policy's
    # provisional verdict; the caller admits the packet to the miss queue.
    pending: bool = False


def _reject_kind(code: int, proto: int) -> int:
    """Scalar twin of models.pipeline.reject_kind_of (ref reject.go) —
    plain conditionals, this runs per packet in the oracle's hot loop."""
    if code != ACT_REJECT:
        return REJECT_NONE
    return REJECT_TCP_RST if proto == PROTO_TCP else REJECT_ICMP_UNREACH


@dataclass
class _LBProgram:
    """One LB program: an endpoint view + affinity.  The scalar twin of the
    compiler's program rows (compiler/services.py): cluster views occupy
    indices 0..len(services)-1, ETP=Local / DSR shadow views follow;
    ETP=Cluster external frontends share the cluster program, with SNAT
    flagged on the FRONTEND entry.  dsr marks a DSR delivery program
    (dedicated per-service view, compiler/services.py prog_dsr)."""

    endpoints: list
    affinity_timeout_s: int
    dsr: bool = False
    # Owning service identity (namespace, name) — the scalar twin of the
    # compiler's prog_svc mapping (toServices peers match on it); None for
    # unnamed services, which cannot be referenced.
    ref: Optional[tuple] = None


def _build_programs(services, node_ips, node_name):
    """-> (programs, frontends {(ip_key, proto, port) -> (prog idx, snat)}).

    Dual-stack: frontends key on COMBINED-keyspace ints (utils/ip.py), so
    v4 and v6 frontends live in one family-agnostic map — the scalar twin
    of the compiler's narrow + lexicographic table split.  Family-purity
    validation mirrors compile_services exactly (metaProxier model)."""
    from ..apis.service import ETP_LOCAL

    node_ips4 = [ip for ip in node_ips if not iputil.is_v6(ip)]
    node_ips6 = [ip for ip in node_ips if iputil.is_v6(ip)]
    progs = [
        _LBProgram(list(s.endpoints), s.affinity_timeout_s,
                   ref=(s.namespace, s.name) if s.name else None)
        for s in services
    ]
    fronts: dict[tuple[int, int, int], tuple[int, int]] = {}

    def add_front(ip_k: int, proto: int, port: int, prog: int, snat: int) -> None:
        key = (ip_k, proto, port)
        if key in fronts:
            # Same observable rule as compile_services: duplicate frontends
            # are a config error, never silent last-writer-wins.
            raise ValueError(
                f"duplicate frontend {iputil.key_to_ip(ip_k)} "
                f"proto {proto} port {port}"
            )
        fronts[key] = (prog, snat)

    for si, svc in enumerate(services):
        fam6 = iputil.is_v6(svc.cluster_ip)
        svc_name = f"{svc.namespace}/{svc.name}" if svc.name else f"svc-{si}"
        for e in svc.endpoints:
            if iputil.is_v6(e.ip) != fam6:
                raise ValueError(
                    f"service {svc_name}: endpoint {e.ip} family differs "
                    f"from cluster IP {svc.cluster_ip} (one ServiceEntry "
                    f"per family, like the reference's per-family proxiers)"
                )
        for ip in svc.external_ips:
            if iputil.is_v6(ip) != fam6:
                raise ValueError(
                    f"service {svc_name}: external IP {ip} family differs "
                    f"from cluster IP {svc.cluster_ip}"
                )
        add_front(iputil.ip_to_key(svc.cluster_ip), svc.protocol, svc.port, si, 0)
        my_node_ips = node_ips6 if fam6 else node_ips4
        has_external = bool(svc.external_ips) or (
            svc.node_port > 0 and my_node_ips
        )
        if not has_external:
            continue
        if svc.external_traffic_policy == ETP_LOCAL:
            ext, ext_snat = len(progs), 0
            progs.append(_LBProgram(
                [e for e in svc.endpoints if e.node == node_name],
                svc.affinity_timeout_s,
                dsr=svc.dsr,
                ref=progs[si].ref,
            ))
        elif svc.dsr:
            # DSR: dedicated program (full endpoint view) carrying the
            # per-program mark; no SNAT (compile_services twin).
            ext, ext_snat = len(progs), 0
            progs.append(_LBProgram(
                list(svc.endpoints), svc.affinity_timeout_s, dsr=True,
                ref=progs[si].ref,
            ))
        else:
            ext, ext_snat = si, 1
        for ip in svc.external_ips:
            add_front(iputil.ip_to_key(ip), svc.protocol, svc.port, ext, ext_snat)
        if svc.node_port > 0:
            for nip in my_node_ips:
                add_front(
                    iputil.ip_to_key(nip), svc.protocol, svc.node_port,
                    ext, ext_snat,
                )
    return progs, fronts


class PipelineOracle:
    def __init__(
        self,
        ps: PolicySet,
        services: list[ServiceEntry],
        *,
        flow_slots: int = 1 << 20,
        aff_slots: int = 1 << 18,
        ct_timeout_s: int = 3600,
        node_ips: list[str] | None = None,
        node_name: str = "",
        ct_syn_timeout_s: int | None = None,
        ct_other_new_s: int | None = None,
        ct_other_est_s: int | None = None,
        dual_stack: bool = False,
        count_flow_stats: bool = False,
        second_chance: bool = False,
    ):
        # Dual-stack mode mirrors the device's wide (10-column) flow-cache
        # keys: addresses hash/compare as 4-word v4-mapped quadruples and
        # v4-mapped v6 twins collapse onto their v4 host (canon_key).
        self.dual_stack = dual_stack
        # Per-entry traffic counters (the device twin's
        # PipelineMeta.count_flow_stats): pkts/octets per direction.
        self.count_flow_stats = count_flow_stats
        self.oracle = Oracle(ps)
        self.flow_slots = flow_slots
        self.aff_slots = aff_slots
        self.ct_timeout_s = ct_timeout_s
        # Per-state conntrack lifetimes, matching PipelineMeta.timeouts:
        # (tcp_syn, tcp_est, other_new, other_est); None = uniform.
        self.ct_timeouts = (
            ct_syn_timeout_s if ct_syn_timeout_s is not None else ct_timeout_s,
            ct_timeout_s,
            ct_other_new_s if ct_other_new_s is not None else ct_timeout_s,
            ct_other_est_s if ct_other_est_s is not None else ct_timeout_s,
        )
        self.node_ips = list(node_ips or [])
        self.node_name = node_name
        self._set_services(services)
        # slot -> {key, code, svc, dnat_ip, dnat_port, ts, gen}; gen None = ALLOW/eternal
        self.flow: dict[int, dict] = {}
        self.aff: dict[int, dict] = {}
        # Live entries overwritten by a DIFFERENT tuple (direct-mapped
        # collision metric; counted sequentially at insert-apply time —
        # within-batch collision accounting is implementation-defined, so
        # this is an operational metric, not a parity field).
        self.evictions = 0
        # Dead rows (idle-expired / stale-gen) reclaimed by drain inserts
        # — the scalar twin of the device's n_reclaim split (counted only
        # when step() runs with reclaim=True, the overlapped drain mode).
        self.reclaims = 0
        # Thrash-resistant replacement (the device twin's second_chance
        # knob, models/pipeline CHANCE_SHIFT): a live CONFIRMED
        # established entry survives colliding inserts while its 2-bit
        # counter is under CHANCE_MAX; its own hit resets the counter.
        self.second_chance = bool(second_chance)
        self.chance_suppressed = 0

    def _set_services(self, services):
        self.services = services
        self.programs, self.svc_by_key = _build_programs(
            services, self.node_ips, self.node_name
        )

    def update(self, ps: PolicySet = None, services: list[ServiceEntry] = None,
               scrub_log: list = None):
        """Control-plane bundle commit: swap rules/services.  The caller
        bumps the device-side gen; here denials are invalidated lazily via
        the stored gen value mismatching.

        scrub_log: the ONLY in-place flow mutation this method performs is
        the vanished-rule attribution scrub below; a caller holding a
        rollback snapshot (the commit plane, oracle_dp._commit_snapshot)
        passes a list and gets (slot, rule_in, rule_out) pre-images
        appended — copy-on-scrub, so the snapshot never clones the cache."""
        if ps is not None:
            self.oracle = Oracle(ps)
            # Attribution follows rule IDENTITY across the bundle (the
            # device twin remaps cached indices by id,
            # TpuflowDatapath._remap_cached_attribution): cached entries
            # whose deciding rule no longer exists lose attribution.
            from ..compiler.ir import rule_id

            live = {
                rule_id(p, i)
                for p in self.oracle.ps.policies
                for i in range(len(p.rules))
            }
            for slot, e in self.flow.items():
                ri, ro = e.get("rule_in"), e.get("rule_out")
                scrub = ((ri is not None and ri not in live)
                         or (ro is not None and ro not in live))
                if not scrub:
                    continue
                if scrub_log is not None:
                    scrub_log.append((slot, ri, ro))
                if ri is not None and ri not in live:
                    e["rule_in"] = None
                if ro is not None and ro not in live:
                    e["rule_out"] = None
        if services is not None:
            self._set_services(services)

    def _k(self, key: int) -> int:
        """Address canonicalization for flow keys: identity in v4-only
        mode; in dual-stack mode the device's wide word form makes a
        v4-mapped v6 address and its v4 host the same key (canon_key)."""
        return iputil.canon_key(key) if self.dual_stack else key

    def _flow_hash(self, p: Packet) -> int:
        return int(self._hash5(p.src_ip, p.dst_ip, p.proto,
                               p.src_port, p.dst_port))

    def _hash5(self, src: int, dst: int, proto: int, sport: int,
               dport: int) -> int:
        if self.dual_stack:
            cols = [np.uint32(w & 0xFFFFFFFF)
                    for w in (*iputil.key_to_flipped_words(src),
                              *iputil.key_to_flipped_words(dst))]
            return int(hashing.flow_hash_wide(cols, proto, sport, dport))
        return int(hashing.flow_hash(
            np.uint32(src), np.uint32(dst), proto, sport, dport
        ))

    def _partner_of(self, e: dict, p: Packet):
        """Partner-direction tuple of a hit entry (the device twin is
        models/pipeline partner_probe — shared by refresh and teardown):
        -> (slot, key, want_rpl)."""
        rpl = e.get("rpl", False)
        t_src = p.dst_ip if rpl else e["dnat_ip"]
        t_dst = e["dnat_ip"] if rpl else p.src_ip
        t_sport = p.dst_port if rpl else e["dnat_port"]
        t_dport = e["dnat_port"] if rpl else p.src_port
        t_h = self._hash5(t_src, t_dst, p.proto, t_sport, t_dport)
        return (
            t_h & (self.flow_slots - 1),
            (self._k(t_src), self._k(t_dst),
             (t_sport << 16) | t_dport, p.proto),
            not rpl,
        )

    def _partner_live(self, flow_view: dict, e: dict, p: Packet):
        """-> verified partner slot or None."""
        slot, key, want_rpl = self._partner_of(e, p)
        e2 = flow_view.get(slot)
        if (
            e2 is not None
            and e2["key"] == key
            and e2["gen"] is None
            and e2.get("rpl", False) == want_rpl
        ):
            return slot
        return None

    def timeout_of(self, e: dict, proto: int) -> int:
        """Per-entry idle timeout (the device twin's entry_timeout): the
        CONFIRMED state + protocol select the kernel-style lifetime."""
        t_syn, t_est, t_onew, t_oest = self.ct_timeouts
        conf = e.get("conf", False)
        if proto == PROTO_TCP:
            return t_est if conf else t_syn
        return t_oest if conf else t_onew

    def lookup(self, flow_view: dict, p: Packet, h: int, now: int, gen_w: int):
        """Read-only flow-cache probe -> (slot, entry-or-None)."""
        slot = h & (self.flow_slots - 1)
        e = flow_view.get(slot)
        key = (self._k(p.src_ip), self._k(p.dst_ip),
               (p.src_port << 16) | p.dst_port, p.proto)
        hit = (
            e is not None
            and e["key"] == key
            and (now - e["ts"]) <= self.timeout_of(e, p.proto)
            and (e["gen"] is None or e["gen"] == gen_w)
        )
        return slot, (e if hit else None)

    def fresh_walk(self, aff_view: dict, p: Packet, h: int, now: int):
        """The slow-path walk (ServiceLB -> DNAT -> classify), read-only.

        -> dict with svc_idx, no_ep, dnat_ip, dnat_port, aff_learn, code,
        plus the classifier's per-direction observations (computed on the
        post-DNAT tuple even for no-endpoint rejects — the what-if a trace
        probe reports; step() discards attribution for those, matching the
        EndpointDNAT-before-policy-tables order).
        """
        svc_idx, front_snat = self.svc_by_key.get(
            (p.dst_ip, p.proto, p.dst_port), (-1, 0)
        )
        prog = self.programs[svc_idx] if svc_idx >= 0 else None
        no_ep = prog is not None and not prog.endpoints

        dnat_ip, dnat_port = p.dst_ip, p.dst_port
        snat = 0
        aff_learn: Optional[tuple[int, dict]] = None
        if prog is not None and not no_ep:
            n_ep = len(prog.endpoints)
            ep_col = (h & 0x7FFFFFFF) % max(1, n_ep)
            if prog.affinity_timeout_s > 0:
                if self.dual_stack:
                    # Wide client hash: 4 words + program, the device's
                    # dual-stack formula (_service_lb) word for word.
                    ah = int(hashing.fnv_mix(
                        [np.uint32(w) for w in iputil.key_to_words(p.src_ip)]
                        + [np.uint32(svc_idx)]
                    ))
                else:
                    ah = int(hashing.fnv_mix(
                        [np.uint32(p.src_ip), np.uint32(svc_idx)]))
                aslot = ah & (self.aff_slots - 1)
                ae = aff_view.get(aslot)
                # ae["ep"] >= n_ep means the endpoint list shrank since the
                # learn: stale — fall through to hash re-select (matches the
                # device's aff_hit staleness guard).  Client identity in
                # canon space: the device compares wide words, under which
                # a v4-mapped v6 client and its v4 host are the same.
                if (
                    ae is not None
                    and ae["client"] == self._k(p.src_ip)
                    and ae["svc"] == svc_idx
                    and ae["ep"] < n_ep
                    and (now - ae["ts"]) <= prog.affinity_timeout_s
                ):
                    ep_col = ae["ep"]
                else:
                    aff_learn = (aslot, {"client": self._k(p.src_ip),
                                         "svc": svc_idx,
                                         "ep": ep_col, "ts": now})
            ep = prog.endpoints[ep_col]
            dnat_ip, dnat_port = iputil.ip_to_key(ep.ip), ep.port
            snat = front_snat

        v = self.oracle.classify(
            Packet(src_ip=p.src_ip, dst_ip=dnat_ip, proto=p.proto,
                   src_port=p.src_port, dst_port=dnat_port),
            # toServices resolution: the owning service identity of the
            # lane's LB program (the device twin's prog_svc gather).
            svc_ref=prog.ref if prog is not None else None,
        )
        code = ACT_REJECT if no_ep else int(v.code)
        return {
            "svc_idx": svc_idx,
            "no_ep": no_ep,
            "dnat_ip": dnat_ip,
            "dnat_port": dnat_port,
            "snat": snat,
            "dsr": 1 if (prog is not None and not no_ep and prog.dsr) else 0,
            "aff_learn": aff_learn,
            "code": code,
            "ingress_code": int(v.ingress.code),
            "ingress_rule": v.ingress.rule,
            "egress_code": int(v.egress.code),
            "egress_rule": v.egress.rule,
        }

    # Lane modes for step(): process normally / SpoofGuard drop (code DROP,
    # nothing touched) / punt to controller (code ALLOW, nothing touched) —
    # the device twin realizes these as the valid mask + kind overrides in
    # models/forwarding._pipeline_step_full.
    LANE_NORMAL = 0
    LANE_SPOOF = 1
    LANE_PUNT = 2

    def step(
        self, batch: PacketBatch, now: int, gen: int = 0, lane_modes=None,
        no_commit=None, flags=None, lens=None, fast_only=None,
        reclaim: bool = False,
    ) -> list[ScalarOutcome]:
        """fast_only (async slow-path mode, datapath/slowpath): when set
        to a verdict code, cache MISSES are not classified — they report
        that provisional code with pending=True and touch no state (the
        caller queues them for a later full-mode drain step).  Hits behave
        exactly as in synchronous mode (refresh/confirm/teardown).

        reclaim (the overlapped drain's fused maintenance, device twin
        meta.drain_reclaim): inserts over DEAD rows — idle-expired per
        the per-state timeout, or stale-generation denials — count as
        `reclaims`, not `evictions` (both classes are already invisible
        to lookups, so overwriting them is reclaimed occupancy)."""
        # The device packs entry generations into GEN_BITS (22) bits, with
        # GEN_ETERNAL reserved for conntrack-committed ALLOW entries; compare
        # against the same wrapped value so spec and device agree across the
        # 2^22-1 commit horizon (the aliasing window — a denial cached
        # exactly 2^22-1 commits ago revalidates — is shared by design).
        gen = gen % GEN_ETERNAL
        flow0 = {k: dict(v) for k, v in self.flow.items()}
        aff0 = {k: dict(v) for k, v in self.aff.items()}
        outs: list[ScalarOutcome] = []
        inserts: list[tuple[int, dict]] = []
        refreshes: list[int] = []
        hit_resets: list[int] = []  # second_chance: hit lanes' own slots
        confirms: list[int] = []
        pref_updates: list[int] = []
        learns: list[tuple[int, dict]] = []
        teardowns: list[int] = []

        from ..compiler.compile import ACT_DROP

        for i in range(batch.size):
            p = batch.packet(i)
            mode = self.LANE_NORMAL if lane_modes is None else lane_modes[i]
            if mode != self.LANE_NORMAL:
                # SpoofGuard-gated or punted lane: handled before the
                # conntrack/policy tables — no lookup, no refresh, no
                # commit (stage order of the reference, framework.go; see
                # models/forwarding.py).  Spoof reports DROP, punt ALLOW
                # (the fast-path default image on the device).
                code = ACT_DROP if mode == self.LANE_SPOOF else ACT_ALLOW
                outs.append(ScalarOutcome(
                    code, False, -1, p.dst_ip, p.dst_port, None, None,
                    False, skipped=True,
                ))
                continue
            h = self._flow_hash(p)
            slot, e = self.lookup(flow0, p, h, now, gen)
            if e is not None:
                est = e["gen"] is None
                rpl_hit = e.get("rpl", False)
                # SNAT mark was pinned into the entry at commit time
                # (ct-mark persistence: later service updates renumbering
                # programs cannot flip an established connection's mark);
                # reply hits un-SNAT via the restored frontend tuple.
                snat = 0 if rpl_hit else e.get("snat", 0)
                # DSR mark was pinned into the entry at commit time, like
                # snat (the device twin's meta3 bit 30): program
                # renumbering cannot flip an established connection's
                # delivery mode.
                dsr = 0 if rpl_hit else e.get("dsr", 0)
                outs.append(
                    ScalarOutcome(
                        e["code"], est, e["svc"], e["dnat_ip"], e["dnat_port"],
                        e["rule_out"], e["rule_in"], False, hit=True,
                        reply=rpl_hit,
                        reject_kind=_reject_kind(e["code"], p.proto),
                        snat=snat, dsr=dsr,
                    )
                )
                refreshes.append(slot)
                hit_resets.append(slot)
                if self.count_flow_stats:
                    # Unbounded Python ints — the scalar twin of the
                    # device's two-limb 64-bit accumulation (the old i32
                    # saturation cap is gone on both engines).
                    ln = 0 if lens is None else max(0, int(lens[i]))
                    live = self.flow.get(slot)
                    if live is not None:
                        live["pkts"] = live.get("pkts", 0) + 1
                        live["octets"] = live.get("octets", 0) + ln
                # SYN_SENT -> ESTABLISHED confirmation (device twin: the
                # CONF_BIT cond in models/pipeline): first reply-direction
                # hit confirms BOTH tuple directions.
                if rpl_hit and not e.get("conf", False):
                    confirms.append(slot)
                    c_slot = self._partner_live(flow0, e, p)
                    if c_slot is not None:
                        confirms.append(c_slot)
                # TCP FIN/RST on an established entry: tear down BOTH tuple
                # directions after this packet's verdict (the conntrack
                # close; conservative vs kernel FIN_WAIT — see the device
                # twin's comment in models/pipeline.py).  Partner verified
                # against start-of-batch state.
                fl = 0 if flags is None else int(flags[i])
                if (est and p.proto == PROTO_TCP
                        and (fl & _TEARDOWN_FLAGS) != 0):
                    teardowns.append(slot)
                    t_slot = self._partner_live(flow0, e, p)
                    if t_slot is not None:
                        teardowns.append(t_slot)
                half = max(1, self.ct_timeout_s // 2)
                if est and (now - e.get("pref", e["ts"])) >= half:
                    # Conntrack refreshes BOTH directions; like the device,
                    # the partner walk is deferred via the entry's pref
                    # stamp (ct_timeout/2 cadence) and the partner entry is
                    # key-verified before the refresh — which also
                    # resurrects an idle-expired partner of a provably live
                    # connection.
                    pref_updates.append(slot)
                    p_slot = self._partner_live(flow0, e, p)
                    if p_slot is not None:
                        refreshes.append(p_slot)
                continue

            if fast_only is not None:
                # Async fast step: the miss is ADMITTED, not classified —
                # provisional verdict, no DNAT, no commit, no learn.
                outs.append(ScalarOutcome(
                    fast_only, False, -1, p.dst_ip, p.dst_port, None, None,
                    False, pending=True,
                ))
                continue

            # ---- slow path: ServiceLB -> classify -> commit ---------------
            w = self.fresh_walk(aff0, p, h, now)
            code = w["code"]
            # No-endpoint reject happens before the policy tables: drop the
            # classifier's what-if attribution.
            rule_in = None if w["no_ep"] else w["ingress_rule"]
            rule_out = None if w["no_ep"] else w["egress_rule"]
            # no_commit lanes (multicast dst): conntrack is bypassed —
            # fresh classification every packet, nothing cached (ref
            # pkg/agent/openflow/multicast.go pipeline skips ct).
            nc = no_commit is not None and bool(no_commit[i])
            committed = code == ACT_ALLOW and not nc
            outs.append(
                ScalarOutcome(code, False, w["svc_idx"], w["dnat_ip"],
                              w["dnat_port"], rule_out, rule_in, committed,
                              reject_kind=_reject_kind(code, p.proto),
                              snat=w["snat"], dsr=w["dsr"])
            )
            if not nc:
                key = (self._k(p.src_ip), self._k(p.dst_ip),
                       (p.src_port << 16) | p.dst_port, p.proto)
                ln = 0 if lens is None else max(0, int(lens[i]))
                inserts.append(
                    (slot, {
                        "key": key, "code": code, "svc": w["svc_idx"],
                        "dnat_ip": w["dnat_ip"], "dnat_port": w["dnat_port"],
                        "ts": now, "pref": now, "snat": w["snat"],
                        "dsr": w["dsr"], "conf": False,
                        "gen": None if committed else gen,
                        "rule_in": rule_in, "rule_out": rule_out,
                        "rpl": False,
                        "pkts": 1 if self.count_flow_stats else 0,
                        "octets": ln if self.count_flow_stats else 0,
                    })
                )
            if committed and not w["dsr"]:
                # Conntrack commits both directions: the reverse-tuple entry
                # is keyed on the post-DNAT tuple with ports swapped
                # (endpoint -> client) and carries the UN-DNAT rewrite (the
                # original frontend) in its dnat fields.  Insert order (fwd
                # then rev, per packet) matches the device's interleaved
                # scatter so eviction races resolve identically.  DSR
                # connections commit NO reply leg (the reply never
                # re-traverses this node; pipeline.go:698-708).
                rev_h = self._hash5(
                    w["dnat_ip"], p.src_ip, p.proto,
                    w["dnat_port"], p.src_port,
                )
                rev_slot = rev_h & (self.flow_slots - 1)
                rev_key = (
                    self._k(w["dnat_ip"]), self._k(p.src_ip),
                    (w["dnat_port"] << 16) | p.src_port, p.proto,
                )
                inserts.append(
                    (rev_slot, {
                        "key": rev_key, "code": code, "svc": w["svc_idx"],
                        "dnat_ip": p.dst_ip, "dnat_port": p.dst_port,
                        "ts": now, "pref": now, "gen": None, "conf": False,
                        "rule_in": rule_in, "rule_out": rule_out,
                        "rpl": True,
                        "pkts": 0, "octets": 0,
                    })
                )
            if w["aff_learn"]:
                learns.append(w["aff_learn"])

        # Apply state mutations in batch order (last writer wins).
        for slot in pref_updates:
            if slot in self.flow:
                self.flow[slot]["pref"] = now
        # Confirmations land BEFORE teardowns/inserts (device order: the
        # CONF meta write precedes key zeroing and slow-path scatters).
        for slot in confirms:
            if slot in self.flow:
                self.flow[slot]["conf"] = True
        # Second-chance hit resets land BEFORE the insert guard reads the
        # counters (device order: the fast-path reset precedes the commit
        # pass's meta read).
        if self.second_chance:
            for slot in hit_resets:
                if slot in self.flow:
                    self.flow[slot]["chance"] = 0
        # Teardowns BEFORE inserts (the device clears keys before the slow
        # path scatters — a miss lane may legitimately re-occupy the slot).
        for slot in teardowns:
            self.flow.pop(slot, None)
        # Second-chance decisions snapshot the counter at pass start (the
        # device evaluates every challenger against the same pre-pass
        # meta and bumps once per slot via the winner mask).
        chance_seen: dict[int, int] = {}
        for slot, entry in inserts:
            old = self.flow.get(slot)
            if old is not None and (
                (old["key"], old.get("rpl", False))
                != (entry["key"], entry.get("rpl", False))
            ):
                if self.second_chance and old["gen"] is None \
                        and old.get("conf", False) \
                        and (now - old["ts"]) <= self.timeout_of(
                            old, old["key"][3]):
                    cnt = chance_seen.get(slot)
                    if cnt is None:
                        cnt = chance_seen[slot] = old.get("chance", 0)
                        if cnt < CHANCE_MAX:
                            old["chance"] = min(CHANCE_MAX, cnt + 1)
                    if cnt < CHANCE_MAX:
                        self.chance_suppressed += 1
                        continue  # challenger stays uncached
                old_dead = reclaim and (
                    (now - old["ts"]) > self.timeout_of(old, old["key"][3])
                    or (old["gen"] is not None and old["gen"] != gen)
                )
                if old_dead:
                    self.reclaims += 1
                else:
                    self.evictions += 1
            self.flow[slot] = entry
        for slot in refreshes:
            if slot in self.flow:
                self.flow[slot]["ts"] = now
        for aslot, entry in learns:
            self.aff[aslot] = entry
        return outs
