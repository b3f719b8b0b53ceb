"""Central control plane (the reference's L4 layer, pkg/controller)."""

from .grouping import GroupEntityIndex, GroupSelector
from .networkpolicy import NetworkPolicyController, WatchEvent

__all__ = [
    "GroupEntityIndex",
    "GroupSelector",
    "NetworkPolicyController",
    "WatchEvent",
]
