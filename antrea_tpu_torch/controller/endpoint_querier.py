"""Endpoint querier: which policies/rules select a given pod, and how.

The analog of the reference's EndpointQuerier
(pkg/controller/networkpolicy/endpoint_querier.go:35,
surfaced via antctl `query endpoint`): answers "what policies apply TO this
endpoint" and "which rules reference it as a PEER", from the controller's
live group index — not by re-evaluating selectors.  The same scan serves
antctl's snapshot-based query (membership sets computed by IP there).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..apis.controlplane import Direction
from .networkpolicy import NetworkPolicyController


@dataclass
class EndpointQueryResponse:
    pod: str  # namespace/name
    # Policies whose (policy- or rule-level) appliedTo includes the pod.
    applied: list = field(default_factory=list)  # [(uid, [rule names/idx])]
    # Rules whose peer address groups include the pod.
    ingress_from: list = field(default_factory=list)  # [(uid, rule idx)]
    egress_to: list = field(default_factory=list)


def scan_policies(policies, applied_groups: set, peer_groups: set):
    """One pass over internal NetworkPolicies -> (applied, ingress_from,
    egress_to) given the endpoint's group memberships (single source of
    truth for the appliedTo-override / peer-direction / isolation-only
    semantics — shared by the live querier and antctl's snapshot query)."""
    applied, ingress_from, egress_to = [], [], []
    for np in policies:
        rules_hit = []
        for i, r in enumerate(np.rules):
            if set(r.applied_to_groups or np.applied_to_groups) & applied_groups:
                rules_hit.append(r.name or str(i))
            if set(r.peer.address_groups) & peer_groups:
                (ingress_from if r.direction == Direction.IN
                 else egress_to).append((np.uid, i))
        if not np.rules and set(np.applied_to_groups) & applied_groups:
            rules_hit.append("<no rules: isolation only>")
        if rules_hit:
            applied.append((np.uid, rules_hit))
    return sorted(applied), sorted(ingress_from), sorted(egress_to)


def query_endpoint(
    ctrl: NetworkPolicyController, namespace: str, name: str
) -> EndpointQueryResponse:
    pod_key = f"{namespace}/{name}"
    groups = ctrl.index.groups_of_pod(pod_key)
    resp = EndpointQueryResponse(pod=pod_key)
    if not groups:
        return resp
    resp.applied, resp.ingress_from, resp.egress_to = scan_policies(
        ctrl._nps.values(), groups, groups
    )
    return resp
