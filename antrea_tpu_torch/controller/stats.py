"""Central stats aggregator: per-node rule metrics -> cluster policy stats.

The analog of pkg/controller/stats (1,114 LoC): agents
periodically report NodeStatsSummary objects (per-policy rule byte/packet
deltas collected from OVS, ref pkg/agent/stats network_policy.go:2034); the
controller aggregates them into the stats API group
(NetworkPolicyStats/AntreaClusterNetworkPolicyStats) that antctl and
kubectl-get consume.

Here a NodeStatsSummary is derived from a Datapath's cumulative counters:
each agent submits its DatapathStats snapshot; the aggregator keeps the
last snapshot per node and serves cluster-wide sums per rule id and per
policy uid (rule ids embed the policy uid via compiler.ir.rule_id's
"<uid>/<direction>/<index>" shape)."""

from __future__ import annotations

from collections import Counter


def _policy_of(rule_id: str) -> str:
    return rule_id.split("/", 1)[0]


class StatsAggregator:
    def __init__(self):
        # node -> {"ingress": {...}, "egress": {...}, defaults...}
        self._nodes: dict[str, dict] = {}

    def report(self, node: str, stats) -> None:
        """Submit a NodeStatsSummary (a DatapathStats snapshot — cumulative
        counters; the last report per node wins, as the reference keeps the
        freshest summary per node)."""
        self._nodes[node] = {
            "ingress": dict(stats.ingress),
            "egress": dict(stats.egress),
            "default_allow": stats.default_allow,
            "default_deny": stats.default_deny,
        }

    def drop_node(self, node: str) -> None:
        """Node gone (the reference GCs summaries of deleted nodes)."""
        self._nodes.pop(node, None)

    def rule_stats(self) -> dict:
        """rule id -> cluster-wide packet count, both directions summed."""
        total: Counter = Counter()
        for s in self._nodes.values():
            for table in ("ingress", "egress"):
                total.update(s[table])
        return dict(total)

    def policy_stats(self) -> dict:
        """policy uid -> packets (the NetworkPolicyStats list body)."""
        per_policy: Counter = Counter()
        for rule, n in self.rule_stats().items():
            per_policy[_policy_of(rule)] += n
        return dict(per_policy)

    def summary(self) -> dict:
        """The stats-API overview antctl renders."""
        return {
            "nodes": len(self._nodes),
            "policies": self.policy_stats(),
            "defaultAllow": sum(
                s["default_allow"] for s in self._nodes.values()
            ),
            "defaultDeny": sum(
                s["default_deny"] for s in self._nodes.values()
            ),
        }
