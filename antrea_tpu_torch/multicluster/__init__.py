"""Multicluster: ClusterSet, service export/import, ACNP replication,
label identities (ref multicluster/)."""

from .core import (
    ClusterSet,
    LabelIdentityIndex,
    LeaderController,
    MemberCluster,
    ResourceExport,
    ResourceImport,
)

__all__ = [
    "ClusterSet",
    "LabelIdentityIndex",
    "LeaderController",
    "MemberCluster",
    "ResourceExport",
    "ResourceImport",
]
