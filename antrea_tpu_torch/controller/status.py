"""NetworkPolicy realization-status aggregation.

The analog of the reference's StatusController
(pkg/controller/networkpolicy/status_controller.go): agents
report, per policy, the spec GENERATION they have realized on their node
(UpdateStatus, :140); the controller aggregates the per-node statuses
against the internal store's current generation + node span (syncHandler,
:270) into a per-policy status:

    phase                Realizing / Realized / Failed (Pending is
                         reserved for a future unprocessed-policy state;
                         every policy in the realization view is already
                         processed, and a processed zero-span policy is
                         Realized — status_controller.go:303-343)
    observed_generation  the spec generation the status describes
    current_nodes        nodes that realized the CURRENT generation
    desired_nodes        the policy's span size

A node status counts toward current_nodes only when its reported
generation equals the policy's current generation and it reports no
realization failure — a lagging agent (older generation) or a failed one
keeps the policy in Realizing/Failed, exactly the reference's rules
(status_controller.go:310-330).  Node statuses for nodes that left the
span are dropped (:314-317).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .networkpolicy import NetworkPolicyController

PHASE_PENDING = "Pending"  # reserved: see module docstring
PHASE_REALIZING = "Realizing"
PHASE_REALIZED = "Realized"
PHASE_FAILED = "Failed"


@dataclass
class NodeStatus:
    """One agent's report for one policy (controlplane
    NetworkPolicyNodeStatus, types.go:440: NodeName, Generation,
    RealizationFailure, Message)."""

    node: str
    generation: int
    failure: bool = False
    message: str = ""


@dataclass
class PolicyStatus:
    """Aggregated per-policy status (crd NetworkPolicyStatus analog)."""

    uid: str
    phase: str
    observed_generation: int
    current_nodes: int
    desired_nodes: int
    failed_nodes: list = field(default_factory=list)  # sorted node names


class StatusAggregator:
    """Holds per-(policy, node) statuses and aggregates on read.

    Reads the internal store through the controller reference — the analog
    of syncHandler's internalNetworkPolicyStore.Get — so status always
    reflects the CURRENT generation/span without a second event plumbing.
    """

    def __init__(self, controller: NetworkPolicyController):
        self._controller = controller
        # policy uid -> node -> NodeStatus
        self._statuses: dict[str, dict[str, NodeStatus]] = {}

    # -- the UpdateStatus RPC (status_controller.go:140) ---------------------

    def update_status(
        self,
        uid: str,
        node: str,
        generation: int,
        *,
        failure: bool = False,
        message: str = "",
    ) -> None:
        self._statuses.setdefault(uid, {})[node] = NodeStatus(
            node=node, generation=generation, failure=failure, message=message
        )

    def update_node_statuses(self, node: str, realized: dict) -> None:
        """Bulk report from one agent: {policy uid: realized generation}.
        Policies the agent no longer holds lose their node status (the
        agent-side delete path of the reference's statusManager)."""
        for uid, gen in realized.items():
            self.update_status(uid, node, int(gen))
        for uid, per_node in self._statuses.items():
            if uid not in realized:
                per_node.pop(node, None)

    # -- aggregation (status_controller.go:270 syncHandler) ------------------

    def status_of(self, uid: str, _view=None) -> PolicyStatus | None:
        view = self._controller.np_realization_view() if _view is None else _view
        if uid not in view:
            # Deleted policy: clear its statuses (syncHandler's not-found
            # path, status_controller.go:273-276).
            self._statuses.pop(uid, None)
            return None
        generation, span = view[uid]
        per_node = self._statuses.get(uid, {})
        # Drop statuses of nodes that left the span.
        for node in [n for n in per_node if n not in span]:
            del per_node[node]
        current = 0
        failed: list[str] = []
        for st in per_node.values():
            if st.generation == generation:
                if st.failure:
                    failed.append(st.node)
                else:
                    current += 1
        desired = len(span)
        if desired == 0:
            # A processed policy with a zero-node span is fully realized
            # (nothing to install anywhere): syncHandler yields Realized
            # when currentNodes == desiredNodes == 0 and reserves Pending
            # for unprocessed policies (status_controller.go:303-343).
            phase = PHASE_REALIZED
        elif current == desired:
            phase = PHASE_REALIZED
        elif current + len(failed) == desired and failed:
            phase = PHASE_FAILED
        else:
            phase = PHASE_REALIZING
        return PolicyStatus(
            uid=uid,
            phase=phase,
            observed_generation=generation,
            current_nodes=current,
            desired_nodes=desired,
            failed_nodes=sorted(failed),
        )

    def make_agent_reporter(self):
        """-> the status_reporter callable AgentPolicyController expects:
        report(node, {uid: generation}, failure="") — the in-proc stand-in
        for the agent's UpdateStatus RPC."""

        def report(node: str, realized: dict, failure: str = "") -> None:
            if failure:
                for uid, gen in realized.items():
                    self.update_status(
                        uid, node, int(gen), failure=True, message=failure
                    )
            else:
                self.update_node_statuses(node, realized)

        return report

    def all_statuses(self) -> list[PolicyStatus]:
        view = self._controller.np_realization_view()
        return [
            s
            for uid in sorted(view)
            if (s := self.status_of(uid, _view=view)) is not None
        ]
