"""Multicast controller: IGMP snooping -> joined-group replication state.

The analog of pkg/agent/multicast (4,260 LoC):
`mcast_controller.go` consumes IGMP packet-ins (reports = joins, leaves),
maintains per-group member status with timeouts (GroupMemberStatus: last
IGMP report per receiver; queryInterval/mcastGroupTimeout), and programs
OVS multicast group buckets; remote-node interest rides the inter-node
protocol so senders replicate to interested peers only.

Here the controller folds membership into `McastGroup` rows pushed through
the NodeRouteController's topology commit (atomic swap into the kernel's
mc table); replication sets are resolved at output time via
`Datapath.mcast_group(mcast_idx)`.

IGMP message kinds (v2 wire types, the subset the reference parses for
join/leave; igmp v3 reports fold to the same membership edges):
  0x16 membership report (join), 0x17 leave group.
"""

from __future__ import annotations

from ..compiler.topology import FIRST_POD_OFPORT, McastGroup, is_mcast_u32
from ..utils import ip as iputil
from .packetin import CAT_IGMP

IGMP_REPORT = 0x16
IGMP_LEAVE = 0x17

# Reference defaults: query interval 125s, member timeout = 260s
# (mcast_controller.go defaults: mcastGroupTimeout = 3 * queryInterval).
DEFAULT_MEMBER_TIMEOUT_S = 260


class MulticastController:
    def __init__(
        self,
        noderoute,  # NodeRouteController: owns the topology commit
        dispatcher=None,  # optional PacketInDispatcher to register with
        member_timeout_s: int = DEFAULT_MEMBER_TIMEOUT_S,
    ):
        self._nrc = noderoute
        self._timeout = member_timeout_s
        # group u32 -> {ofport: last_report_ts} (GroupMemberStatus analog)
        self._members: dict[int, dict[int, int]] = {}
        # group u32 -> set of remote node names with receivers
        self._remote: dict[int, set] = {}
        if dispatcher is not None:
            dispatcher.register(CAT_IGMP, self.handle_igmp)

    # -- IGMP packet-in (mcast_controller.go addGroupMemberStatus) -----------

    def handle_igmp(self, item: dict, now: int) -> None:
        group = item["group_ip"]
        port = item["in_port"]
        # Only POD ports register local receivers (compile_topology's own
        # port classification): an IGMP report arriving via the tunnel or
        # gateway must not add those ports as replication targets — remote
        # interest rides set_remote_interest exclusively.
        if not is_mcast_u32(group) or port < FIRST_POD_OFPORT:
            return
        if item["kind"] == IGMP_REPORT:
            self.join(group, port, now)
        elif item["kind"] == IGMP_LEAVE:
            self.leave(group, port)

    def join(self, group_u32: int, ofport: int, now: int) -> None:
        m = self._members.setdefault(group_u32, {})
        fresh = ofport not in m
        m[ofport] = now
        if fresh:
            self._reinstall()

    def leave(self, group_u32: int, ofport: int) -> None:
        m = self._members.get(group_u32)
        if m and m.pop(ofport, None) is not None:
            if not m:
                del self._members[group_u32]
            self._reinstall()

    def expire(self, now: int) -> int:
        """Drop receivers whose last report is older than the timeout (the
        reference's periodic group cleanup against queryInterval misses).
        -> receivers expired."""
        n = 0
        changed = False
        for group in list(self._members):
            m = self._members[group]
            for port in list(m):
                if now - m[port] > self._timeout:
                    del m[port]
                    n += 1
                    changed = True
            if not m:
                del self._members[group]
        if changed:
            self._reinstall()
        return n

    # -- remote interest (inter-node replication; the reference carries this
    # via its node-to-node multicast protocol) -------------------------------

    def set_remote_interest(self, group_ip: str, node_names) -> None:
        g = iputil.ip_to_u32(group_ip)
        # Validate BEFORE mutating: a non-multicast group stored here would
        # make every later _reinstall raise from compile_topology (this
        # controller's maps have no per-event rollback).
        if not is_mcast_u32(g):
            raise ValueError(f"{group_ip} is not a multicast group")
        nodes = set(node_names)
        if nodes:
            if self._remote.get(g) == nodes:
                return
            self._remote[g] = nodes
        elif g in self._remote:
            del self._remote[g]
        else:
            return
        self._reinstall()

    # -- state ---------------------------------------------------------------

    def groups(self) -> list[McastGroup]:
        out = []
        for g in sorted(set(self._members) | set(self._remote)):
            out.append(McastGroup(
                group_ip=iputil.u32_to_ip(g),
                local_ports=tuple(sorted(self._members.get(g, ()))),
                remote_nodes=tuple(sorted(self._remote.get(g, ()))),
            ))
        return out

    def _reinstall(self) -> None:
        self._nrc.set_mcast_groups(self.groups())
