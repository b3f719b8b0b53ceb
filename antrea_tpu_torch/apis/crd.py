"""Raw (user-facing) API objects: K8s core objects + policy CRDs.

These are the INPUTS to the central control plane — the analog of the K8s
objects and Antrea CRDs the reference's controller watches:

  * Pod/Namespace — the entity side of the grouping index
    (ref pkg/controller/grouping/group_entity_index.go:57).
  * K8sNetworkPolicy — networking/v1 NetworkPolicy spec subset
    (ref pkg/controller/networkpolicy/networkpolicy_controller.go:1498
    processNetworkPolicy path).
  * AntreaNetworkPolicy / AntreaClusterNetworkPolicy — the ANNP/ACNP CRDs
    (ref pkg/apis/crd/v1beta1; conversion in
    pkg/controller/networkpolicy/clusternetworkpolicy.go).

Only the fields the datapath build consumes are modeled; everything here is
hashable/canonicalizable so selectors can be content-addressed the way the
reference normalizes group selectors (networkpolicy_controller.go
normalizedNameForSelector).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .controlplane import Direction, IPBlock, RuleAction

# -- label selectors ---------------------------------------------------------

OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_NOT_EXISTS = "DoesNotExist"


@dataclass(frozen=True)
class SelectorRequirement:
    """One matchExpressions entry (metav1.LabelSelectorRequirement)."""

    key: str
    operator: str  # In / NotIn / Exists / DoesNotExist
    values: tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector subset: matchLabels + matchExpressions.

    An EMPTY selector matches every object (K8s semantics); None at a use
    site means "no selector given", which callers must interpret per-field
    (e.g. NP peer with nil podSelector).
    """

    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[SelectorRequirement, ...] = ()

    @staticmethod
    def make(
        labels: Optional[dict] = None,
        expressions: Optional[list[SelectorRequirement]] = None,
    ) -> "LabelSelector":
        return LabelSelector(
            match_labels=tuple(sorted((labels or {}).items())),
            match_expressions=tuple(expressions or ()),
        )

    def matches(self, labels: dict) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            present = req.key in labels
            if req.operator == OP_EXISTS:
                if not present:
                    return False
            elif req.operator == OP_NOT_EXISTS:
                if present:
                    return False
            elif req.operator == OP_IN:
                if not present or labels[req.key] not in req.values:
                    return False
            elif req.operator == OP_NOT_IN:
                if present and labels[req.key] in req.values:
                    return False
            else:
                raise ValueError(f"unknown selector operator {req.operator}")
        return True

    def canonical(self) -> str:
        exprs = ",".join(
            f"{r.key} {r.operator} [{','.join(sorted(r.values))}]"
            for r in sorted(self.match_expressions, key=lambda r: (r.key, r.operator))
        )
        lbls = ",".join(f"{k}={v}" for k, v in self.match_labels)
        return f"ml({lbls});me({exprs})"


# -- core objects ------------------------------------------------------------


@dataclass
class Pod:
    namespace: str
    name: str
    ip: str = ""
    node: str = ""
    labels: dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Namespace:
    name: str
    labels: dict = field(default_factory=dict)


# -- K8s NetworkPolicy (networking/v1 subset) --------------------------------


@dataclass(frozen=True)
class K8sPeer:
    """NetworkPolicyPeer: exactly one of (selectors, ip_block) in practice.

    pod_selector/ns_selector semantics (upstream):
      pod only  -> pods matching it in the policy's namespace
      ns only   -> all pods in matching namespaces
      both      -> pods matching pod_selector in matching namespaces
    """

    pod_selector: Optional[LabelSelector] = None
    ns_selector: Optional[LabelSelector] = None
    ip_block: Optional[IPBlock] = None


@dataclass(frozen=True)
class PortSpec:
    """NetworkPolicyPort / Antrea rule port: protocol + port[-end_port],
    or an ICMP type[/code] constraint (the crd `protocols: icmp:` form,
    ref crd Rule.Protocols -> controlplane Service ICMPType/ICMPCode)."""

    protocol: Optional[int] = 6  # TCP default per K8s API
    port: Optional[int] = None
    end_port: Optional[int] = None
    icmp_type: Optional[int] = None
    icmp_code: Optional[int] = None


@dataclass
class K8sNPRule:
    peers: list[K8sPeer] = field(default_factory=list)  # empty = any peer
    ports: list[PortSpec] = field(default_factory=list)  # empty = any port


@dataclass
class K8sNetworkPolicy:
    uid: str
    namespace: str
    name: str
    pod_selector: LabelSelector = field(default_factory=LabelSelector)
    policy_types: list[Direction] = field(default_factory=list)
    ingress: list[K8sNPRule] = field(default_factory=list)
    egress: list[K8sNPRule] = field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# -- Antrea-native policies (ANNP/ACNP subset) -------------------------------


@dataclass(frozen=True)
class ServiceReference:
    """Namespaced Service reference (crd NamespacedName, types.go:598 —
    the `toServices` egress peer form)."""

    name: str
    namespace: str = "default"

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.name)


@dataclass(frozen=True)
class AntreaPeer:
    """ACNP/ANNP rule peer.  `group` references a ClusterGroup by name
    (crd NetworkPolicyPeer.group); `fqdn` is a domain-name peer whose
    membership is learned from the dataplane's DNS responses (ref
    pkg/agent/controller/networkpolicy/fqdn.go; egress rules only, per
    upstream).  The forms are mutually exclusive per upstream validation.

    `to_services` (crd Rule.ToServices, types.go:598; resolved by the
    reference controller in antreanetworkpolicy.go:130-131): the peer is
    a set of SERVICES — the rule matches traffic addressed to any
    frontend of a referenced Service (the ServiceGroupID conjunction of
    the reference's openflow layer).  Egress-only; exclusive of every
    other peer field and of rule ports, per upstream validation."""

    pod_selector: Optional[LabelSelector] = None
    ns_selector: Optional[LabelSelector] = None
    ip_block: Optional[IPBlock] = None
    group: str = ""
    fqdn: str = ""
    to_services: tuple[ServiceReference, ...] = ()


@dataclass(frozen=True)
class AntreaAppliedTo:
    pod_selector: Optional[LabelSelector] = None
    ns_selector: Optional[LabelSelector] = None


@dataclass
class AntreaNPRule:
    direction: Direction
    action: RuleAction = RuleAction.ALLOW
    peers: list[AntreaPeer] = field(default_factory=list)  # empty = any
    ports: list[PortSpec] = field(default_factory=list)  # empty = any
    applied_to: list[AntreaAppliedTo] = field(default_factory=list)  # override
    name: str = ""
    # crd L7Protocols (http/tls rule specs in the reference); upstream
    # validation: L7 rules must be action Allow.
    l7_protocols: tuple = ()


@dataclass
class AntreaNetworkPolicy:
    """ANNP (namespaced) or ACNP (namespace == '')."""

    uid: str
    name: str
    namespace: str = ""  # "" = cluster-scoped (ACNP)
    tier_priority: int = 250  # TIER_APPLICATION
    # Named tier (crd spec.tier): when set, the controller resolves it
    # against the Tier registry and OVERRIDES tier_priority.
    tier: str = ""
    priority: float = 5.0
    applied_to: list[AntreaAppliedTo] = field(default_factory=list)
    rules: list[AntreaNPRule] = field(default_factory=list)

    @property
    def is_cluster_scoped(self) -> bool:
        return self.namespace == ""

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


# -- Tier CRD (crd/v1beta1 Tier) ---------------------------------------------


@dataclass
class AdminNetworkPolicy:
    """sig-network-api AdminNetworkPolicy subset (the reference implements
    it in pkg/controller/networkpolicy/adminnetworkpolicy handling;
    NetworkPolicyType.ADMIN in controlplane types.go:200-218).

    Cluster-scoped; `priority` 0-1000, LOWER evaluates earlier; subject is
    either whole namespaces (ns selector only) or pods (ns + pod selector);
    rule actions Allow / Deny / Pass.  Evaluated BEFORE K8s NetworkPolicies
    (its own band ahead of the Antrea application tier)."""

    name: str
    priority: int  # 0-1000
    subject: AntreaAppliedTo = None
    rules: list[AntreaNPRule] = field(default_factory=list)

    @property
    def uid(self) -> str:
        return f"anp-{self.name}"


@dataclass
class BaselineAdminNetworkPolicy:
    """sig-network-api BaselineAdminNetworkPolicy: a cluster singleton
    (name must be 'default') evaluated AFTER K8s NetworkPolicies — the
    baseline tier; actions Allow / Deny only."""

    subject: AntreaAppliedTo = None
    rules: list[AntreaNPRule] = field(default_factory=list)
    name: str = "default"

    @property
    def uid(self) -> str:
        return f"banp-{self.name}"


@dataclass
class Tier:
    """Custom evaluation tier for Antrea-native policies.

    Ref: crd/v1beta1.Tier + the controller's static default tiers
    (pkg/controller/networkpolicy — Emergency(50),
    SecurityOps(100), NetworkOps(150), Platform(200), Application(250),
    Baseline(253)); lower priority evaluates earlier.
    """

    name: str
    priority: int
    description: str = ""


# The default tiers the reference controller creates at startup.
DEFAULT_TIERS = [
    Tier("emergency", 50),
    Tier("securityops", 100),
    Tier("networkops", 150),
    Tier("platform", 200),
    Tier("application", 250),
    Tier("baseline", 253),
]


# -- ClusterGroup CRD (crd/v1beta1 ClusterGroup) ------------------------------


@dataclass
class ClusterGroup:
    """Named reusable group ACNP peers reference by name.

    Ref: crd/v1beta1.ClusterGroup (pkg/controller/networkpolicy group
    handling): exactly one of (selector form, ipBlocks, childGroups) per
    upstream validation; childGroups union their members.
    """

    name: str
    pod_selector: Optional[LabelSelector] = None
    ns_selector: Optional[LabelSelector] = None
    ip_blocks: list[IPBlock] = field(default_factory=list)
    child_groups: list[str] = field(default_factory=list)

    @property
    def is_selector(self) -> bool:
        return self.pod_selector is not None or self.ns_selector is not None
