"""Scalar reference interpreter: packet -> verdict.

This is the executable *specification* of the datapath: it walks one packet
through the same decision procedure the reference's OVS pipeline implements
with flow tables, and every batched TPU kernel must agree with it bit-for-bit
(the verdict-parity requirement in BASELINE.md).

Evaluation order per direction, mirroring the OVS tables
(pkg/agent/openflow/pipeline.go:114-195 and
docs/design/ovs-pipeline.md:1685-1760):

  1. AntreaPolicy{Ingress,Egress}Rule — Antrea-native rules from non-Baseline
     tiers, in (tier priority, policy priority, rule index) order; the first
     matching rule decides: Allow / Drop / Reject are final, Pass falls
     through to the K8s phase.
  2. {Ingress,Egress}Rule — K8s NetworkPolicy allow rules (unordered; any
     match allows), combined with {Ingress,Egress}DefaultRule isolation:
     a pod selected by any K8s NP in this direction is default-deny, so
     "isolated and no allow rule matched" => Drop, final.  K8s isolation
     cannot be overridden by Baseline-tier rules (upstream K8s semantics).
  3. Baseline-tier rules (installed in the DefaultRule tables below the K8s
     default-deny in the reference), first match decides; Pass means "no
     opinion" and falls to:
  4. default Allow.

A packet's final verdict combines the egress evaluation at its source pod and
the ingress evaluation at its destination: any Drop/Reject wins over Allow.
Service DNAT happens *before* policy evaluation (PreRouting stage precedes
EgressSecurity, pipeline.go stages), so callers evaluating post-LB traffic
pass the DNAT-ed destination; the full-pipeline oracle in
antrea_tpu.oracle.pipeline composes that ordering.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from ..apis.controlplane import (
    PROTO_ICMP,
    PROTO_SCTP,
    PROTO_TCP,
    PROTO_UDP,
    Direction,
    NetworkPolicy,
    NetworkPolicyRule,
    RuleAction,
    Service,
)
from ..compiler.ir import PolicySet, rule_id
from ..packet import Packet


class VerdictCode(enum.IntEnum):
    # Values match the compiled action encoding in compiler/compile.py.
    ALLOW = 0
    DROP = 1
    REJECT = 2


@dataclass(frozen=True)
class DirectionVerdict:
    code: VerdictCode
    rule: Optional[str]  # rule_id of the deciding rule; None = default allow


@dataclass(frozen=True)
class Verdict:
    code: VerdictCode
    egress: DirectionVerdict
    ingress: DirectionVerdict


def _service_matches(svc: Service, pkt: Packet) -> bool:
    if svc.protocol is not None and svc.protocol != pkt.proto:
        return False
    if svc.port is not None and pkt.proto in (PROTO_TCP, PROTO_UDP, PROTO_SCTP):
        hi = svc.end_port if svc.end_port is not None else svc.port
        if not (svc.port <= pkt.dst_port <= hi):
            return False
    if svc.icmp_type is not None and pkt.proto == PROTO_ICMP:
        # ICMP lanes carry (type << 8) | code in dst_port (the datapath
        # convention — Service.ICMPType/ICMPCode, types.go:311).
        if (pkt.dst_port >> 8) != svc.icmp_type:
            return False
        if svc.icmp_code is not None and (pkt.dst_port & 0xFF) != svc.icmp_code:
            return False
    return True


class Oracle:
    def __init__(self, ps: PolicySet):
        from ..compiler.ir import resolve_named_ports

        # Named ports resolve through the SAME pass the compiler uses —
        # twin parity on named-port semantics by construction.
        self.ps = resolve_named_ports(ps)
        # An Oracle treats its PolicySet as immutable (every consumer —
        # PipelineOracle.update, the commit-plane canary, parity suites —
        # builds a fresh Oracle on change), so membership material is
        # resolved once per instance instead of per classify: batch
        # consumers (the canary probes every bundle commit) would otherwise
        # re-sort the rule set and re-merge every group's ranges per
        # packet.  The cached forms preserve the PolicySet helpers'
        # semantics exactly (same ranges()/ip_to_key comparisons).
        self._ordered_cache: dict = {}  # (direction, baseline) -> rules
        self._group_ranges: dict = {}  # address-group name -> merged ranges
        self._applied_keys: dict = {}  # appliedTo-group name -> member keys
        self._block_ranges: dict = {}  # (cidr, excepts) -> ranges
        self._isolated_keys: dict = {}  # direction -> isolated pod keys

    # -- memoized membership (same semantics as the PolicySet helpers) -------

    def _ranges_of_group(self, gname: str):
        got = self._group_ranges.get(gname)
        if got is None:
            g = self.ps.address_groups.get(gname)
            got = self._group_ranges[gname] = (
                g.ranges() if g is not None else [])
        return got

    def _keys_of_applied(self, gname: str):
        got = self._applied_keys.get(gname)
        if got is None:
            from ..utils import ip as iputil

            g = self.ps.applied_to_groups.get(gname)
            got = self._applied_keys[gname] = (
                frozenset(iputil.ip_to_key(m.ip) for m in g.members)
                if g is not None else frozenset())
        return got

    def _ranges_of_block(self, block):
        from ..utils import ip as iputil

        key = (block.cidr, tuple(block.excepts))
        got = self._block_ranges.get(key)
        if got is None:
            got = self._block_ranges[key] = iputil.ipblock_to_ranges(
                block.cidr, block.excepts)
        return got

    def _peer_contains(self, peer, ip_key: int) -> bool:
        from ..utils import ip as iputil

        if peer.is_any:
            return True
        for gname in peer.address_groups:
            if iputil.ip_in_ranges(ip_key, self._ranges_of_group(gname)):
                return True
        return any(
            iputil.ip_in_ranges(ip_key, self._ranges_of_block(b))
            for b in peer.ip_blocks
        )

    def _applied_to_contains(self, policy, rule, ip_key: int) -> bool:
        groups = rule.applied_to_groups or policy.applied_to_groups
        return any(ip_key in self._keys_of_applied(g) for g in groups)

    def _k8s_isolated(self, ip_key: int, direction: Direction) -> bool:
        got = self._isolated_keys.get(direction)
        if got is None:
            keys: set = set()
            for p in self.ps.policies:
                if not p.is_k8s or direction not in p.policy_types:
                    continue
                for gname in p.applied_to_groups:
                    keys |= self._keys_of_applied(gname)
            got = self._isolated_keys[direction] = frozenset(keys)
        return ip_key in got

    # -- single rule ---------------------------------------------------------

    def _rule_matches(
        self, policy: NetworkPolicy, rule: NetworkPolicyRule, pkt: Packet,
        svc_ref=None,
    ) -> bool:
        if rule.direction == Direction.IN:
            pod_ip, peer_ip = pkt.dst_ip, pkt.src_ip
        else:
            pod_ip, peer_ip = pkt.src_ip, pkt.dst_ip
        if not self._applied_to_contains(policy, rule, pod_ip):
            return False
        if rule.direction == Direction.OUT and rule.peer.to_services:
            # toServices peer (egress-only): the match rides on the
            # packet's ServiceLB RESOLUTION, not its addresses — the
            # scalar twin of the device's svcref probe (ops/match).
            # svc_ref is the resolved service's (namespace, name), or
            # None when the packet resolved to no service.
            return svc_ref is not None and svc_ref in {
                sr.key for sr in rule.peer.to_services
            }
        if not self._peer_contains(rule.peer, peer_ip):
            return False
        if rule.services and not any(_service_matches(s, pkt) for s in rule.services):
            return False
        return True

    # -- one direction -------------------------------------------------------

    def _ordered_antrea_rules(self, direction: Direction, baseline: bool):
        cached = self._ordered_cache.get((direction, baseline))
        if cached is not None:
            return cached
        out = []
        for p in self.ps.policies:
            if p.is_k8s or p.is_baseline != baseline:
                continue
            for i, r in enumerate(p.rules):
                if r.direction != direction:
                    continue
                out.append(((p.tier_priority, p.priority, r.priority, p.uid), p, i, r))
        out.sort(key=lambda t: t[0])
        self._ordered_cache[(direction, baseline)] = out
        return out

    def evaluate_direction(self, pkt: Packet, direction: Direction,
                           svc_ref=None) -> DirectionVerdict:
        # Phase 1: Antrea-native, non-Baseline tiers.
        passed = False
        for _, p, i, r in self._ordered_antrea_rules(direction, baseline=False):
            if self._rule_matches(p, r, pkt, svc_ref):
                if r.action == RuleAction.PASS:
                    passed = True
                    break
                code = {
                    RuleAction.ALLOW: VerdictCode.ALLOW,
                    RuleAction.DROP: VerdictCode.DROP,
                    RuleAction.REJECT: VerdictCode.REJECT,
                }[r.action]
                return DirectionVerdict(code, rule_id(p, i))

        # Phase 2: K8s NetworkPolicies (allow rules + isolation default-deny).
        pod_ip = pkt.dst_ip if direction == Direction.IN else pkt.src_ip
        isolated = self._k8s_isolated(pod_ip, direction)
        if isolated:
            for p in self.ps.policies:
                if not p.is_k8s:
                    continue
                for i, r in enumerate(p.rules):
                    if r.direction == direction and self._rule_matches(p, r, pkt):
                        return DirectionVerdict(VerdictCode.ALLOW, rule_id(p, i))
            return DirectionVerdict(VerdictCode.DROP, None)
        del passed  # Pass into an empty K8s phase falls through to baseline.

        # Phase 3: Baseline tier.
        for _, p, i, r in self._ordered_antrea_rules(direction, baseline=True):
            if self._rule_matches(p, r, pkt, svc_ref):
                if r.action == RuleAction.PASS:
                    break
                code = {
                    RuleAction.ALLOW: VerdictCode.ALLOW,
                    RuleAction.DROP: VerdictCode.DROP,
                    RuleAction.REJECT: VerdictCode.REJECT,
                }[r.action]
                return DirectionVerdict(code, rule_id(p, i))

        # Phase 4: default allow.
        return DirectionVerdict(VerdictCode.ALLOW, None)

    # -- full packet ---------------------------------------------------------

    def classify(self, pkt: Packet, svc_ref=None) -> Verdict:
        """svc_ref: the packet's ServiceLB resolution as the resolved
        service's (namespace, name) — None when not service-addressed.
        Consumed only by toServices egress peers."""
        eg = self.evaluate_direction(pkt, Direction.OUT, svc_ref)
        ing = self.evaluate_direction(pkt, Direction.IN, svc_ref)
        if eg.code != VerdictCode.ALLOW:
            final = eg.code
        else:
            final = ing.code
        return Verdict(code=final, egress=eg, ingress=ing)
