"""Node-agent layer (ref: pkg/agent): watch client, rule cache, reconciler."""

from .controller import AgentPolicyController

__all__ = ["AgentPolicyController"]
