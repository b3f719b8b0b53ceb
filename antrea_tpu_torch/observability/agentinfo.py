"""Agent heartbeat info: the AntreaAgentInfo CRD analog.

The reference's monitor publishes AntreaAgentInfo/AntreaControllerInfo
health CRDs every 60s (pkg/monitor/agent.go:30-96:
version, node, OVS info, NP counts, conditions).  collect_agent_info is
the per-tick producer; the dissemination/K8s write is the caller's."""

from __future__ import annotations

import time

from ..antctl import VERSION


def collect_agent_info(datapath, node: str, agent=None, now=None) -> dict:
    stats = datapath.stats()
    info = {
        "kind": "AntreaAgentInfo",
        "version": VERSION,
        "nodeName": node,
        "heartbeatUnix": time.time() if now is None else now,
        "datapath": {
            "type": str(datapath.datapath_type.value),
            "generation": datapath.generation,
            "cache": datapath.cache_stats(),
        },
        "networkPolicyStats": {
            "ingressRules": len(stats.ingress),
            "egressRules": len(stats.egress),
            "defaultAllow": stats.default_allow,
            "defaultDeny": stats.default_deny,
        },
        "conditions": [{
            "type": "AgentHealthy",
            "status": "True",
        }],
    }
    if agent is not None:
        ps = agent.policy_set
        info["networkPolicies"] = len(ps.policies)
        info["addressGroups"] = len(ps.address_groups)
        info["appliedToGroups"] = len(ps.applied_to_groups)
    return info


def collect_controller_info(controller, store=None, now=None, status=None) -> dict:
    """AntreaControllerInfo heartbeat (ref pkg/monitor controller side:
    version, connected-agent count, NP/group counts, conditions, service
    CIDR/cluster identity when known).  `controller` is a
    NetworkPolicyController; `store` an optional RamStore whose watcher
    count is the connected-agent gauge; `status` an optional
    StatusAggregator whose per-policy realization phases are summarized
    (the kubectl-visible NetworkPolicyStatus surface,
    status_controller.go:281-287)."""
    info = {
        "kind": "AntreaControllerInfo",
        "version": VERSION,
        "heartbeatUnix": time.time() if now is None else now,
        **controller.object_counts(),
        "conditions": [{
            "type": "ControllerHealthy",
            "status": "True",
        }],
    }
    if store is not None:
        info["connectedAgentNum"] = store.n_watchers
    if status is not None:
        statuses = status.all_statuses()
        info["networkPolicyRealization"] = {
            "policies": [
                {
                    "uid": s.uid,
                    "phase": s.phase,
                    "observedGeneration": s.observed_generation,
                    "currentNodesRealized": s.current_nodes,
                    "desiredNodesRealized": s.desired_nodes,
                    "failedNodes": s.failed_nodes,
                }
                for s in statuses
            ],
            "realized": sum(1 for s in statuses if s.phase == "Realized"),
            "total": len(statuses),
        }
    return info
