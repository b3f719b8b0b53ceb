"""Cluster identity: a stable cluster UUID minted once, readable forever.

The analog of pkg/clusteridentity: the antrea-controller
creates the `antrea-cluster-identity` ConfigMap with a random UUID on first
boot and every component reads it thereafter (used by multicluster and
telemetry to name the cluster).  Here the identity lives in the native
transactional config store (the OVSDB external-IDs analog) so it survives
restarts.

Concurrency contract: like the reference — where a single controller
replica owns the create (K8s Create-if-absent serializes it) — minting
assumes ONE writer process; the store has no compare-and-swap, so two
processes racing the first boot could each mint a UUID with last-commit-
wins.  The commit-then-re-read below makes a process return the durably
stored value whenever the store can already see the winner, but true
multi-writer first-boot needs the K8s-side create, not this path."""

from __future__ import annotations

import uuid

_KEY = "cluster/identity"


def get_or_create_cluster_identity(store) -> str:
    """-> the cluster UUID string, minting it on first call."""
    raw = store.get(_KEY)
    if raw is not None:
        return raw.decode()
    ident = str(uuid.uuid4())
    store.set(_KEY, ident.encode())
    store.commit()
    # Return what is durably stored, not what we minted — if another
    # writer's commit landed in between, converge on it.
    raw = store.get(_KEY)
    return raw.decode() if raw is not None else ident
