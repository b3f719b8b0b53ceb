"""Agent-side FQDN policy controller: the DNS packet-in feedback loop.

The analog of the reference's fqdnController
(pkg/agent/controller/networkpolicy/fqdn.go:125 — DNS
responses punted from the dataplane (PacketInCategoryDNS, packetin.go:44)
are parsed and fed back into the policy state as address-group updates,
with TTL-based expiry).  Here the feedback target is the datapath's
incremental delta path: an FQDN rule compiles to an 'fqdn--<pattern>'
AddressGroup (controller/networkpolicy._ensure_fqdn_group), and every DNS
observation patches the LOCAL datapath's copy of that group — per-node
learned state, exactly like the reference's per-agent fqdn cache.

Matching (fqdn.go semantics): exact names case-insensitively; a leading
'*.' wildcard matches one or more labels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..compiler.ir import PolicySet
from ..datapath.interface import Datapath

FQDN_PREFIX = "fqdn--"


def fqdn_groups(ps: PolicySet) -> dict[str, str]:
    """group key -> pattern for every FQDN-learned group in a PolicySet."""
    return {
        name: name[len(FQDN_PREFIX):]
        for name in ps.address_groups
        if name.startswith(FQDN_PREFIX)
    }


def fqdn_matches(pattern: str, name: str) -> bool:
    pattern = pattern.lower().rstrip(".")
    name = name.lower().rstrip(".")
    if pattern.startswith("*."):
        suffix = pattern[2:]
        return name.endswith("." + suffix)
    return name == pattern


@dataclass
class _Learned:
    expires: int  # seconds


class FqdnController:
    """Per-node DNS-learned membership for fqdn-- groups.

    TTL GC runs as the `fqdn-ttl` task of the datapath's maintenance
    scheduler (datapath/maintenance.py): `register_maintenance()` wires
    `tick()` in, and expiry then consults the SCHEDULER'S monotonic tick
    clock — one notion of `now` across every background plane, so
    fault-injected time (dissemination/faults.FaultClock) drives FQDN
    expiry as deterministically as the other loops."""

    def __init__(self, datapath: Datapath):
        self.datapath = datapath
        self._patterns: dict[str, str] = {}  # group key -> pattern
        # (group, ip) -> expiry bookkeeping for TTL-based removal.
        self._learned: dict[tuple[str, str], _Learned] = {}
        self._sched = None  # maintenance scheduler once registered

    def register_maintenance(self, scheduler, budget: int = 256) -> None:
        """Register the TTL GC as the scheduler's `fqdn-ttl` task (budget
        = expired learns processed per tick).  From then on `tick()` with
        no explicit `now` reads the scheduler's clock."""
        from ..datapath.maintenance import MaintenanceTask

        self._sched = scheduler
        scheduler.register(MaintenanceTask(
            "fqdn-ttl",
            lambda now, grant: self.tick(now, limit=grant),
            budget=budget, priority=3))

    def configure(self, ps: PolicySet) -> None:
        """(Re)derive the watched patterns AND restore learned membership.

        Call after every structural datapath bundle (and only then): a
        bundle recompiles groups from the central PolicySet, where fqdn--
        groups are always empty — without re-applying the per-node learned
        addresses here, FQDN deny rules would silently fail OPEN until the
        next DNS response for each name.  This controller is the sole
        writer of fqdn-- group membership on its datapath, so post-bundle
        re-apply is exact (the bundle reset the refcounts to zero)."""
        self._patterns = fqdn_groups(ps)
        by_group: dict[str, list[str]] = {}
        for key in list(self._learned):
            group, ip = key
            if group not in self._patterns:
                del self._learned[key]  # rule gone; bundle removed the group
            else:
                by_group.setdefault(group, []).append(ip)
        for group, ips in by_group.items():
            self._apply_delta(group, ips, [])

    def _apply_delta(self, group: str, added: list, removed: list) -> bool:
        """Guarded datapath delta: a QUARANTINED datapath (degraded after a
        commit-plane rollback, datapath/commit.py) rejects deltas with
        BundleQuarantinedError — that must not crash the DNS packet-in or
        TTL-GC paths.  Returns False then; recovery is a full bundle, after
        which the agent calls configure() and learned membership re-applies
        from self._learned."""
        from ..datapath.commit import BundleQuarantinedError

        try:
            self.datapath.apply_group_delta(group, added, removed)
            return True
        except BundleQuarantinedError:
            return False

    def observe_dns(self, name: str, ips: list[str], ttl_s: int, now: int) -> int:
        """One DNS response (the packet-in payload): add the resolved
        addresses to every matching fqdn group; refresh TTLs.  Returns the
        number of datapath group updates applied."""
        updates = 0
        for group, pattern in self._patterns.items():
            if not fqdn_matches(pattern, name):
                continue
            added = []
            for ip in ips:
                k = (group, ip)
                if k in self._learned:
                    self._learned[k].expires = now + ttl_s
                else:
                    self._learned[k] = _Learned(expires=now + ttl_s)
                    added.append(ip)
            if added:
                if self._apply_delta(group, added, []):
                    updates += 1
                else:
                    # Quarantined: forget the rejected members so the next
                    # DNS response (or post-recovery configure()) re-adds
                    # them — _learned must mirror what was actually pushed.
                    for ip in added:
                        self._learned.pop((group, ip), None)
        return updates

    def tick(self, now: Optional[int] = None, limit: Optional[int] = None) -> int:
        """Expire TTL-stale learned addresses (fqdn.go's TTL GC); returns
        the number of expired learns removed.  `now=None` reads the
        maintenance scheduler's tick clock (register_maintenance);
        `limit` caps the expiries processed this tick (the scheduler's
        budget unit) — the rest stay learned until a later tick, which is
        safe: deny rules fail CLOSED, never open."""
        if now is None:
            if self._sched is None:
                raise ValueError(
                    "FqdnController.tick() needs an explicit now= until "
                    "register_maintenance() wires the scheduler clock")
            now = self._sched.clock()
        by_group: dict[str, list[str]] = {}
        expired = 0
        for (group, ip), st in list(self._learned.items()):
            if limit is not None and expired >= limit:
                break
            if st.expires <= now:
                by_group.setdefault(group, []).append(ip)
                del self._learned[(group, ip)]
                expired += 1
        for group, ips in by_group.items():
            # A quarantine here leaves the expired members installed a
            # little longer (deny rules fail CLOSED, never open); the
            # post-recovery bundle + configure() rebuilds membership from
            # _learned, which already dropped them.
            self._apply_delta(group, [], ips)
        return expired
