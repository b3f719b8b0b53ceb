"""Datapath restart persistence: snapshot + reload of compiled inputs.

The cookie-round recovery model of the reference
(pkg/agent/openflow/cookie/allocator.go:76-135 — round
number persisted in OVSDB external-IDs; pkg/agent/agent.go:486-512 — a
restarted agent installs the new round's flows, then deletes stale-round
flows, make-before-break): here the persisted unit is the datapath's INPUT
state (PolicySet + services + generation), because the compiled tensors are
a pure function of it and recompiling on boot is cheaper than managing
binary tensor compatibility.  SURVEY §5 maps this to "rule tensors are the
checkpoint — persist compiled tensors + round id; reload and
recompile-and-swap"; persisting the pre-compile state realizes the same
recovery with a stable schema (dissemination/serde.py wire format).

Flow-cache (conntrack) state is deliberately dropped on restart: in the
reference it lives in the kernel and survives the agent, but here it is
device memory owned by the process; established connections re-classify on
first packet (a fresh commit), which changes cold-start cost, never
verdicts.  The generation stays monotonic across restarts so any cached
state that DID survive (e.g. a future device-resident store) could never
alias a pre-restart denial.
"""

from __future__ import annotations

import hashlib
import json
import os

from ..apis.service import ServiceEntry
from ..compiler.ir import PolicySet
from ..dissemination import serde

SNAPSHOT_VERSION = 2  # v2: two-slot + checksum; v1 (no checksum) still loads
_FILE = "datapath_snapshot.json"
_LKG_FILE = "datapath_snapshot.lkg.json"


def snapshot_path(persist_dir: str) -> str:
    return os.path.join(persist_dir, _FILE)


def lkg_snapshot_path(persist_dir: str) -> str:
    """The last-known-good slot: on every save the PREVIOUS latest snapshot
    (which passed its commit canary when it was written) rotates here."""
    return os.path.join(persist_dir, _LKG_FILE)


def atomic_write_json(path: str, body: object) -> None:
    """Durable atomic JSON write (tmp + fsync + rename): a crash mid-save
    leaves the previous file intact — the OVSDB-transaction analog.  Shared
    by datapath snapshots and the agent filestore."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(body, f, separators=(",", ":"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str, expect: type = dict):
    """-> parsed JSON of the expected top-level type, else None (any
    read/parse/shape failure is a fresh-boot condition for all consumers —
    including valid-but-foreign JSON like a top-level list)."""
    try:
        with open(path) as f:
            body = json.load(f)
    except (OSError, ValueError):
        return None
    return body if isinstance(body, expect) else None


def _checksum(body: dict) -> str:
    """Integrity digest over the canonical JSON of the payload fields
    (hashlib is stdlib — NOT the `cryptography` wheel, absent on some
    images; this is corruption detection, not authentication)."""
    payload = json.dumps(
        {k: v for k, v in body.items() if k != "checksum"},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def _verify(body: dict) -> bool:
    if body.get("v") == 1:
        return True  # pre-checksum snapshots carry no integrity field
    return body.get("checksum") == _checksum(body)


def save_snapshot(
    persist_dir: str, ps: PolicySet, services: list[ServiceEntry], gen: int,
    *, tenants: list | None = None, fault=None,
) -> None:
    """Two-slot rotating save: the previous LATEST (canary-certified when
    it was committed) is copied to the LKG slot, then the new snapshot
    atomically replaces latest.  Crash windows:

      * mid-rotate: latest intact; a torn LKG fails its checksum and the
        loader skips it (latest still wins);
      * between the two writes (`fault("between_slots")` lets tests inject
        exactly this crash): latest still holds the OLD state and LKG a
        copy of it — the two slots can never BOTH be lost;
      * mid-latest-write: atomic_write_json leaves the old latest intact.
    """
    latest = snapshot_path(persist_dir)
    prev = read_json(latest)
    if prev is not None and _verify(prev):
        atomic_write_json(lkg_snapshot_path(persist_dir), prev)
    if fault is not None:
        fault("between_slots")
    body = {
        "v": SNAPSHOT_VERSION,
        "generation": gen,
        "policySet": serde.encode_policy_set(ps),
        "services": [serde.encode_service_entry(s) for s in services],
    }
    if tenants:
        # Per-tenant INPUT state (spec + policy set + generation) — the
        # same persisted-unit rule as the default world: compiled tensors
        # are a pure function of it, so restore recompiles each world.
        # Still v2: the key is optional and covered by the checksum, so
        # pre-tenant snapshots keep loading unchanged.
        body["tenants"] = tenants
    body["checksum"] = _checksum(body)
    atomic_write_json(latest, body)


def _decode_snapshot(body: dict):
    try:
        return (
            serde.decode_policy_set(body["policySet"]),
            [serde.decode_service_entry(s) for s in body.get("services", ())],
            int(body["generation"]),
        )
    except (ValueError, KeyError, TypeError, AttributeError):
        return None


def load_snapshot_body(persist_dir: str):
    """-> the newest INTACT raw snapshot body (checksum-verified,
    version-gated, decodable), else None.  `load_snapshot` decodes the
    default-world triple out of it; the tenancy plane reads the optional
    `tenants` list separately, because tenant worlds can only be rebuilt
    AFTER the engine's compile machinery exists (end of the ctor)."""
    for path in (snapshot_path(persist_dir), lkg_snapshot_path(persist_dir)):
        body = read_json(path)
        if body is None or body.get("v") not in (1, SNAPSHOT_VERSION):
            continue
        if not _verify(body):
            continue
        if _decode_snapshot(body) is not None:
            return body
    return None


def load_snapshot(persist_dir: str):
    """-> (PolicySet, services, generation) from the newest INTACT slot:
    latest first, then the LKG slot when latest is absent, truncated,
    checksum-corrupt, or undecodable.  Only when BOTH slots fail is the
    boot fresh — the reference behaves the same when OVSDB external-IDs
    are missing: new round, full reinstall.  (The cookie-round journal is
    consulted separately, so an LKG fallback never rolls the generation
    backwards — see PersistableDatapath.)"""
    body = load_snapshot_body(persist_dir)
    return None if body is None else _decode_snapshot(body)


# Topology persists in its OWN small file, written per topology event —
# O(topology) disk work, not O(policy-state); the analog of the reference
# persisting port rows in OVSDB (one row per pod interface) separately from
# flow state.  Snapshots never carry topology.
_TOPO_FILE = "topology.json"


def topology_path(persist_dir: str) -> str:
    return os.path.join(persist_dir, _TOPO_FILE)


def save_topology(persist_dir: str, topo) -> None:
    atomic_write_json(topology_path(persist_dir), {
        "v": SNAPSHOT_VERSION,
        "topology": serde.encode_topology(topo),
    })


def load_topology(persist_dir: str):
    """-> Topology or None (absent/unreadable == fresh boot).  v1 files
    (written before the two-slot snapshot bumped SNAPSHOT_VERSION) still
    load — the topology schema itself did not change."""
    body = read_json(topology_path(persist_dir))
    if body is None or body.get("v") not in (1, SNAPSHOT_VERSION):
        return None
    try:
        return serde.decode_topology(body["topology"])
    except (ValueError, KeyError, TypeError, AttributeError):
        return None


class PersistableDatapath:
    """Shared restart-persistence behavior for Datapath implementations
    (single source of truth for the recovery contract; both datapaths mix
    this in).  Expects subclasses to hold _ps, _services, _gen.

    Two durable pieces, matching the reference's split:
      * the JSON snapshot (full input state) — written on bundle commits;
      * the cookie ROUND in the native transactional config store
        (native/ovsdb_lite, the OVSDB external-IDs analog,
        cookie/allocator.go:76-135) — a tiny journal append on EVERY
        generation bump, including the delta path that does not snapshot.
    On reload the generation is max(snapshot, round journal), so delta
    bumps taken after the last snapshot can never roll the generation
    backwards across a crash (a rolled-back generation could alias a
    pre-crash cached denial).
    """

    _ROUND_KEY = "cookie/round"

    def _init_persist(self, persist_dir, ps, services) -> None:
        """Call from __init__ AFTER _ps/_services/_gen defaults are set:
        loads the snapshot when constructed without explicit state."""
        self._persist_dir = persist_dir
        self._persist_dirty = False
        self._conf_store = None
        if persist_dir is None:
            return
        from ..native import ConfigStore

        self._conf_store = ConfigStore(os.path.join(persist_dir, "conf.db"))
        if ps is None and services is None:
            body = load_snapshot_body(persist_dir)
            if body is not None:
                self._ps, self._services, self._gen = _decode_snapshot(body)
                # Tenant worlds restore later (datapath/tenancy
                # _restore_tenant_worlds, called from _init_tenancy at
                # the END of the ctor): rebuilding a world is a full
                # compile, impossible this early in construction.
                self._pending_tenant_restore = body.get("tenants") or None
        # Topology restores independently of the rule snapshot; an
        # explicitly-passed topology wins (same contract as ps/services).
        if getattr(self, "_topo", None) is None:
            topo = load_topology(persist_dir)
            if topo is not None:
                self._topo = topo
        # The round journal is consulted UNCONDITIONALLY: even a datapath
        # reconstructed with explicit state must resume past the durable
        # round, or its first bump would overwrite the journal with a
        # smaller value and a later snapshotless reload could alias
        # pre-crash cached denials.
        raw = self._conf_store.get(self._ROUND_KEY)
        if raw is not None:
            self._gen = max(self._gen, int.from_bytes(raw, "little"))

    def _record_round(self) -> None:
        """Durable generation bump without an O(state) snapshot (the
        delta-path cookie-round append)."""
        if self._conf_store is not None:
            self._conf_store.set(
                self._ROUND_KEY, int(self._gen).to_bytes(8, "little")
            )
            self._conf_store.commit()

    def _persist(self) -> None:
        if self._persist_dir is not None:
            # Tenant worlds ride the same two-slot snapshot (the tenancy
            # mixin provides the encoder; engines without it save the
            # pre-tenant body byte-for-byte).
            enc = getattr(self, "_tenant_snapshot_worlds", None)
            # _persist_fault: optional crash-injection hook (tests) fired
            # between the two slot writes — see save_snapshot.
            save_snapshot(self._persist_dir, self._ps, self._services,
                          self._gen,
                          tenants=None if enc is None else enc(),
                          fault=getattr(self, "_persist_fault", None))
            self._record_round()
        self._persist_dirty = False

    def _persist_topology(self) -> None:
        if self._persist_dir is not None:
            save_topology(self._persist_dir, self._topo)

    def checkpoint(self) -> None:
        """Flush a pending (delta-dirtied) snapshot to disk."""
        if self._persist_dirty:
            self._persist()
