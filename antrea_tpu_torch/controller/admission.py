"""Admission validation + mutation for policy-family objects.

The analog of the reference controller's validating/mutating webhooks
(pkg/controller/networkpolicy/validate.go:134 the validator
registry, :307+ the per-kind validate paths, :995-1012 tier create
validation; mutate.go:109-143 tier defaulting + rule-name generation).  In
the reference these run as K8s admission webhooks BEFORE the controller
sees the object; here they run at the top of every
NetworkPolicyController.upsert_* so an invalid object can never reach group
interning, dissemination, or compile_policy_set.

Rules modeled (each cites its reference behavior):

  Tier       - priority must not collide with a reserved (default) tier or
               an existing tier (validate.go:1001-1008); bounded tier count
               (:996); deletion with referencing policies refused (handled
               in NetworkPolicyController.delete_tier, validate.go:1037).
  ACNP/ANNP  - referenced tier must exist (validate.go:831-838);
               Pass action forbidden in the baseline tier (:845-860);
               rule names unique within the policy (:591-603);
               appliedTo in spec XOR in rules, all rules or none, and at
               least one of the two (:605-627);
               peer forms mutually exclusive per peer (group vs selectors
               vs ipBlock vs fqdn; :691+ numFieldsSetInStruct);
               fqdn peers egress-only (:973-981 + upstream fqdn contract);
               ipBlock CIDR/except syntactic validity, excepts inside the
               cidr (:783-804);
               port specs: end_port needs port, end_port >= port, 0-65535
               (:396-431);
               L7 rules must be Allow (validateL7Protocols :938; also
               enforced at the controller seam).
  ANP/BANP   - priority 0-1000, BANP singleton 'default' (validate.go:1207,
               :1214; enforced in the controller's upsert paths).
  ClusterGroup - exactly one membership form (selectors / ipBlocks /
               childGroups, validate.go:1051-1068); ipBlock validity
               (:1089-1106); child groups must not nest further (:1109).

Mutations (mutate.go):
  - empty tier name defaults to 'application' (mutate.go:122-125);
  - unnamed rules get generated, stable names (mutate.go:117-121, :143).
"""

from __future__ import annotations

import hashlib
from dataclasses import replace

from ..apis import controlplane as cp
from ..apis.crd import (
    AntreaNetworkPolicy,
    AntreaNPRule,
    AntreaPeer,
    ClusterGroup,
    IPBlock,
    K8sNetworkPolicy,
    PortSpec,
    Tier,
)
from ..utils import ip as iputil

# Reserved = the static default tiers the controller pre-creates plus the
# internal ANP band (validate.go reservedTierPriorities).  Derived from the
# authoritative DEFAULT_TIERS list so the two cannot drift.
from ..apis.crd import DEFAULT_TIERS as _DEFAULT_TIERS  # noqa: E402

RESERVED_TIER_PRIORITIES = frozenset(
    {t.priority for t in _DEFAULT_TIERS} | {cp.TIER_ADMINNP}
)
DEFAULT_TIER_NAMES = frozenset(t.name for t in _DEFAULT_TIERS)
MAX_TIERS = 20  # validate.go:996 maxSupportedTiers
DEFAULT_TIER_NAME = "application"  # mutate.go:122-125
BASELINE_TIER_NAME = "baseline"


class AdmissionDenied(ValueError):
    """A webhook rejection: the object never reaches the controller state."""


def _deny(reason: str) -> None:
    raise AdmissionDenied(reason)


# -- shared field checks -----------------------------------------------------


def _check_cidr(cidr: str, what: str) -> tuple[int, int]:
    try:
        return iputil.cidr_to_range(cidr)
    except Exception as e:  # malformed ip or mask
        _deny(f"invalid {what} CIDR value {cidr!r}: {e}")


def _check_ip_block(b: IPBlock | cp.IPBlock, what: str = "ipBlock") -> None:
    lo, hi = _check_cidr(b.cidr, what)
    for ex in b.excepts:
        xlo, xhi = _check_cidr(ex, f"{what} except")
        if xlo < lo or xhi > hi:
            _deny(
                f"{what} except CIDR {ex!r} is not strictly within "
                f"the CIDR {b.cidr!r}"
            )


def _check_ports(ports: list[PortSpec], where: str) -> None:
    for p in ports:
        if p.port is not None and not (0 <= p.port <= 65535):
            _deny(f"{where}: port {p.port} out of range 0-65535")
        if p.end_port is not None:
            if p.port is None:
                _deny(f"{where}: endPort cannot be set without a port")
            if not (0 <= p.end_port <= 65535):
                _deny(f"{where}: endPort {p.end_port} out of range 0-65535")
            if p.end_port < p.port:
                _deny(
                    f"{where}: endPort {p.end_port} is smaller than "
                    f"port {p.port}"
                )


def _peer_forms(peer: AntreaPeer) -> int:
    forms = 0
    if peer.pod_selector is not None or peer.ns_selector is not None:
        forms += 1
    if peer.ip_block is not None:
        forms += 1
    if peer.group:
        forms += 1
    if peer.fqdn:
        forms += 1
    if peer.to_services:
        forms += 1
    return forms


# -- Tier --------------------------------------------------------------------


def validate_tier(tier: Tier, existing: dict[str, Tier]) -> None:
    """validate.go:995-1012 tier createValidate + the update rules: the
    static default tiers are immutable, and no tier — created OR updated —
    may take a reserved priority or collide with an existing one."""
    if tier.name in DEFAULT_TIER_NAMES:
        _deny(f"default tier {tier.name} is immutable")
    others = {n: t for n, t in existing.items() if n != tier.name}
    if len(others) >= MAX_TIERS:
        _deny(f"maximum number of Tiers supported: {MAX_TIERS}")
    if tier.priority in RESERVED_TIER_PRIORITIES:
        _deny(f"tier {tier.name} priority {tier.priority} is reserved")
    for other in others.values():
        if other.priority == tier.priority:
            _deny(
                f"tier {tier.name} priority {tier.priority} overlaps with "
                f"existing Tier {other.name}"
            )


# -- Antrea-native policies (ACNP / ANNP) ------------------------------------


def _rule_hash(rule: AntreaNPRule) -> str:
    """Stable content hash for generated rule names (mutate.go:194
    hashRule)."""
    h = hashlib.sha256(repr(rule).encode()).hexdigest()
    return h[:5]


def mutate_antrea_policy(anp: AntreaNetworkPolicy) -> AntreaNetworkPolicy:
    """The mutating-webhook pass (mutate.go:109-143): default the tier and
    generate names for unnamed rules.  Pure - returns a mutated copy."""
    rules = []
    seen: set[str] = {r.name for r in anp.rules if r.name}
    for r in anp.rules:
        if r.name:
            rules.append(r)
            continue
        prefix = "ingress" if r.direction == cp.Direction.IN else "egress"
        name = f"{prefix}-{r.action.value.lower()}-{_rule_hash(r)}"
        n, base = 2, name
        while name in seen:  # hash collision among unnamed twins
            name, n = f"{base}-{n}", n + 1
        seen.add(name)
        rules.append(replace(r, name=name))
    # Tier-name defaulting applies only to objects that did not choose a
    # band programmatically (tier_priority left at the application default):
    # a named tier overrides tier_priority at conversion, so defaulting the
    # name on a priority-carrying object would silently move the policy.
    tier = anp.tier
    if not tier and anp.tier_priority == cp.TIER_APPLICATION:
        tier = DEFAULT_TIER_NAME
    return replace(anp, tier=tier, rules=rules)


def validate_antrea_policy(
    anp: AntreaNetworkPolicy,
    tiers: dict[str, Tier],
    cluster_groups: dict[str, ClusterGroup],
) -> None:
    """The validating-webhook pass for ACNP/ANNP (validate.go:525-589)."""
    # Tier must exist (validate.go:831-838).  Named tier is resolved against
    # the registry; policies carrying only a numeric tier_priority (the
    # programmatic path) skip the name check.
    tier = None
    if anp.tier:
        tier = tiers.get(anp.tier)
        if tier is None:
            _deny(f"tier {anp.tier} does not exist")
    # Pass action is meaningless in the last tier (validate.go:845-860).
    is_baseline = (
        (tier is not None and tier.priority == cp.TIER_BASELINE)
        or (anp.tier or "").lower() == BASELINE_TIER_NAME
        or (not anp.tier and anp.tier_priority == cp.TIER_BASELINE)
    )
    if is_baseline:
        for r in anp.rules:
            if r.action == cp.RuleAction.PASS:
                _deny(
                    "`Pass` action should not be set for Baseline Tier "
                    "policy rules"
                )
    # Rule names unique within the policy (validate.go:591-603).
    seen: set[str] = set()
    for r in anp.rules:
        if r.name:
            if r.name in seen:
                _deny("rules names must be unique within the policy")
            seen.add(r.name)
    # appliedTo placement (validate.go:605-627): spec XOR rules; if in
    # rules, ALL rules must carry it; at least one of the two.
    in_spec = bool(anp.applied_to)
    rules_with_at = sum(1 for r in anp.rules if r.applied_to)
    if in_spec and rules_with_at > 0:
        _deny("appliedTo should not be set in both spec and rules")
    if not in_spec and rules_with_at == 0:
        _deny("appliedTo needs to be set in either spec or rules")
    if rules_with_at > 0 and rules_with_at != len(anp.rules):
        _deny(
            "appliedTo field should either be set in all rules or in "
            "none of them"
        )
    # Peers (validate.go:691+): forms mutually exclusive; groups must
    # exist; ipBlocks syntactically valid; fqdn egress-only.
    for r in anp.rules:
        for peer in r.peers:
            if _peer_forms(peer) > 1:
                _deny(
                    "group/fqdn/ipBlock cannot be set with other peer "
                    "fields in a rule peer"
                )
            if peer.group and peer.group not in cluster_groups:
                _deny(f"cluster group {peer.group} does not exist")
            if peer.ip_block is not None:
                _check_ip_block(peer.ip_block)
            if peer.fqdn and r.direction != cp.Direction.OUT:
                _deny("fqdn peers are only supported in egress rules")
            # toServices placement (validate.go toServices checks, crd
            # types.go:598): egress-only, exclusive of rule ports (the
            # referenced Services' own (proto, port) define the match),
            # and exclusive of every OTHER peer in the rule — upstream
            # rejects ToServices combined with `to`, and a merged rule
            # peer would otherwise silently drop the non-service peers
            # (the compiler's to_services branch matches on the ServiceLB
            # resolution alone).
            if peer.to_services:
                if r.direction != cp.Direction.OUT:
                    _deny("`toServices` can only be used in egress rules")
                if r.ports:
                    _deny(
                        "`toServices` cannot be used with `ports` in the "
                        "same rule"
                    )
                if len(r.peers) > 1:
                    _deny(
                        "`toServices` cannot be used with other rule "
                        "peers"
                    )
        _check_ports(r.ports, f"rule {r.name or r.direction.value}")
        # L7 rules must be Allow (validate.go:938-971).
        if r.l7_protocols and r.action != cp.RuleAction.ALLOW:
            _deny("layer 7 protocols only support Allow action")


# -- K8s NetworkPolicy -------------------------------------------------------


def validate_k8s_policy(np: K8sNetworkPolicy) -> None:
    """K8s NP objects arrive API-validated in the reference; the checks the
    datapath still depends on (CIDR syntax, port ranges) are enforced here
    so a malformed object cannot poison the compiler."""
    for rules in (np.ingress, np.egress):
        for r in rules:
            for peer in r.peers:
                if peer.ip_block is not None:
                    _check_ip_block(peer.ip_block)
            _check_ports(r.ports, "K8s NetworkPolicy rule")


# -- ClusterGroup ------------------------------------------------------------


def validate_cluster_group(
    cg: ClusterGroup, existing: dict[str, ClusterGroup]
) -> None:
    """validate.go:1051-1068 (exactly one membership form), :1089-1106
    (ipBlock validity), :1109-1133 (no nested child groups)."""
    forms = 0
    if cg.is_selector:
        forms += 1
    if cg.ip_blocks:
        forms += 1
    if cg.child_groups:
        forms += 1
    if forms == 0:
        _deny(f"cluster group {cg.name} must set one membership form")
    if forms > 1:
        _deny(
            f"cluster group {cg.name}: at most one of "
            "selectors/ipBlocks/childGroups can be set"
        )
    for b in cg.ip_blocks:
        _check_ip_block(b, "group ipBlock")
    for child_name in cg.child_groups:
        child = existing.get(child_name)
        if child is not None and child.child_groups:
            _deny(
                f"cluster group {cg.name}: child group {child_name} "
                "itself has child groups (max nesting depth is 1)"
            )
