"""Fake-agent fleet: scale-testing the controller's watch fan-out.

The analog of cmd/antrea-agent-simulator
(simulator.go:15-18; docs/antrea-agent-simulator.md): watch-only fake
agents deployed at scale to stress the controller's dissemination plane —
they subscribe like real agents, track what they receive, and never touch a
dataplane.  BASELINE.json names this as the CPU-reference driver.

Each agent maintains the same local object tables a real
AgentPolicyController would, so fleet-wide assertions can check span
filtering (an agent sees a policy iff the policy spans its node) and
fan-out cost (events delivered vs objects changed).

Transports — the reference has exactly ONE dissemination path, the
authenticated network apiserver (apiserver.go:97-99), and the fleet's
primary mode mirrors it:

  * ``transport="netwire"`` — each agent is a real mTLS TCP client of a
    DisseminationServer (dissemination/netwire.py): events arrive over
    sockets, realization statuses flow back over the same channel.  This
    is the production-shaped path.
  * ``transport="inproc"`` — direct RamStore watchers, a fallback for
    pure fan-out unit tests where socket setup cost would dominate.
"""

from __future__ import annotations

import time
from typing import Optional

from ..controller.networkpolicy import WatchEvent
from ..dissemination.netwire import ReconnectingClient
from ..observability.metrics import Histogram


class _AgentTables:
    """Shared local-object-table logic (the watch-consumer half every
    agent flavor reuses — one _apply, one realization view, one resync
    window for the server's re-list protocol)."""

    def _init_tables(self) -> None:
        self.policies: dict[str, object] = {}
        self.address_groups: dict[str, object] = {}
        self.applied_to_groups: dict[str, object] = {}
        self.events_seen = 0
        self.resyncs_seen = 0
        self._in_resync = False
        self._resync_seen: set = set()
        # Realization latency (PR 8 span plumbing, the fleet's half of
        # ROADMAP item 3's "p99 < 1s at 10k agents" target): a fake agent
        # realizes an object the moment it lands in its table, so the
        # span is controller-commit (WatchEvent.ts, stamped by
        # RamStore.apply / carried over the wire) -> table apply.
        # Unstamped events (resync replays) are excluded and METERED,
        # never guessed into the histogram.
        self.realization_hist = Histogram()
        self.realization_unstamped = 0

    def _observe_realization(self, ev: WatchEvent) -> None:
        if ev.ts:
            self.realization_hist.observe(
                max(0.0, time.monotonic() - ev.ts))
        else:
            self.realization_unstamped += 1

    def realized_generations(self) -> dict:
        return {
            uid: getattr(p, "generation", 0)
            for uid, p in self.policies.items()
        }

    def _tables(self):
        return (
            ("NetworkPolicy", self.policies),
            ("AddressGroup", self.address_groups),
            ("AppliedToGroup", self.applied_to_groups),
        )

    def _apply(self, ev: WatchEvent) -> None:
        self._observe_realization(ev)
        table = dict(self._tables())[ev.obj_type]
        if ev.kind == "DELETED":
            table.pop(ev.name, None)
            if self._in_resync:
                self._resync_seen.discard((ev.obj_type, ev.name))
        else:
            table[ev.name] = ev.obj
            if self._in_resync:
                self._resync_seen.add((ev.obj_type, ev.name))

    def _apply_ctl(self, kind: str) -> None:
        """Resync markers bracket a full re-list: on resync_end anything
        not re-delivered inside the window is stale and dropped (state
        that changed while this agent was disconnected)."""
        if kind == "resync_begin":
            self._in_resync = True
            self._resync_seen = set()
        elif kind == "resync_end" and self._in_resync:
            for obj_type, table in self._tables():
                for name in [n for n in table
                             if (obj_type, n) not in self._resync_seen]:
                    del table[name]
            self._in_resync = False
            self.resyncs_seen += 1


class FakeAgent(_AgentTables):
    def __init__(self, store, node: str, status_reporter=None, *,
                 max_pending=None):
        self.node = node
        self._store = store
        self._watcher = store.watch_queue(node, max_pending=max_pending)
        self._init_tables()
        # Realization-status reporting (same callable contract as
        # AgentPolicyController): a fake agent "realizes" a policy the
        # moment it lands in its table, so a fleet agent that has NOT been
        # pumped is exactly a lagging node in the status aggregation.
        self._status_reporter = status_reporter

    def pump(self) -> int:
        """Drain pending events into the local tables; -> events consumed.
        A watcher that overflowed its bounded queue gets the full re-list
        (store.resync) with the same retract-stale semantics as the wire."""
        n = 0
        if self._watcher.needs_resync:
            self._apply_ctl("resync_begin")
            for ev in self._store.resync(self._watcher):
                self._apply(ev)
                n += 1
            self._apply_ctl("resync_end")
        for ev in self._watcher.drain():
            self._apply(ev)
            n += 1
        self.events_seen += n
        if n and self._status_reporter is not None:
            self._status_reporter(self.node, self.realized_generations())
        return n

    def stop(self) -> None:
        self._watcher.stop()


class NetFakeAgent(_AgentTables, ReconnectingClient):
    """Watch-only fake agent over the REAL mTLS wire: a TLS-verified
    client of DisseminationServer that maintains the same tables and
    reports realization over the same socket (netwire.NetAgent minus the
    dataplane — the agent-simulator over the production transport).

    Same failure model as NetAgent BY CONSTRUCTION: the dial / dead-socket
    / backoff-reconnect lifecycle is the shared ReconnectingClient; the
    server's resync markers drive retract-stale reconciliation on
    re-handshake."""

    def __init__(self, node: str, address, certdir: str, *,
                 reconnect: bool = True, backoff=None, fault_wrap=None):
        self._init_tables()
        self._init_wire(node, address, certdir,
                        reconnect=reconnect, backoff=backoff,
                        fault_wrap=fault_wrap)

    # Short first-wait: FakeAgentFleet.pump() ships events BEFORE draining
    # agents, so loopback frames are already buffered — a long per-agent
    # select would make an idle fleet pump O(agents * wait).
    def pump(self, wait: float = 0.05) -> int:
        import ssl

        from ..dissemination import serde

        if self._sock is None and not self._try_reconnect():
            return 0
        n = 0
        try:
            frames = self._conn.recv_ready(first_wait=wait)
        except (OSError, ssl.SSLError, ValueError):
            self._mark_dead()
            return 0
        for frame in frames:
            if "ev" in frame:
                self._apply(serde.decode_event(frame["ev"]))
                n += 1
            elif "ctl" in frame:
                self._apply_ctl(frame["ctl"])
        self.events_seen += n
        if self._conn.closed:
            self._mark_dead()
            return n
        if n:
            # Realization report upstream over the SAME TLS channel (the
            # UpdateStatus RPC analog); the server's next pump() feeds it
            # into the StatusAggregator.
            try:
                self._sock.setblocking(True)
                self._conn.send({"status": self.realized_generations()})
                self._sock.setblocking(False)
            except (OSError, ssl.SSLError):
                self._mark_dead()
        return n

    def stop(self) -> None:
        self.close()  # the fleet's uniform agent-stop verb


class FakeAgentFleet:
    """Fleet over either transport.  netwire mode needs a live
    DisseminationServer (events + statuses ride its sockets; pass its
    certdir); inproc mode needs the RamStore."""

    def __init__(self, store, nodes: list[str], status_reporter=None, *,
                 transport: str = "inproc", server=None, certdir: str = "",
                 max_pending=None, fault_plan=None, backoff_factory=None):
        self.transport = transport
        self._server = server
        if transport == "netwire":
            if server is None or not certdir:
                raise ValueError(
                    "netwire fleet needs server= (DisseminationServer) "
                    "and certdir="
                )
            if status_reporter is not None:
                raise ValueError(
                    "status_reporter is an inproc-transport hook; netwire "
                    "statuses flow to the server's StatusAggregator over "
                    "the sockets"
                )

            def _wrap(node):
                # Chaos hook: interpose FaultySocket per agent so the plan's
                # {node}.send / {node}.recv sites fire on the live fleet.
                if fault_plan is None:
                    return None
                from ..dissemination.faults import FaultySocket
                return lambda sock, _n=node: FaultySocket(
                    sock, fault_plan, _n)

            self.agents = {
                n: NetFakeAgent(
                    n, server.address, certdir,
                    backoff=backoff_factory(n) if backoff_factory else None,
                    fault_wrap=_wrap(n))
                for n in nodes
            }
            # TLS bring-up is serial per agent: scale the registration
            # deadline with fleet size (soaks run 10^2-10^4 agents).
            server.wait_connected(len(nodes),
                                  timeout=max(5.0, 0.05 * len(nodes)))
        elif transport == "inproc":
            self.agents = {
                n: FakeAgent(store, n, status_reporter=status_reporter,
                             max_pending=max_pending)
                for n in nodes
            }
        else:
            raise ValueError(f"unknown fleet transport {transport!r}")

    def pump(self) -> int:
        """One dissemination round; -> events consumed fleet-wide.

        netwire: ship queued events down every socket, then ONE bounded
        select across the whole fleet picks the agents with data (a
        serial per-agent wait would make an idle pump O(agents * wait) —
        the same discipline as DisseminationServer.pump) and only those
        block-drain; finally consume the statuses they sent back."""
        if self.transport == "netwire":
            import select

            self._server.pump()
            # Disconnected agents (backoff window) have _sock=None: they
            # must not enter the select set (None is unselectable) — their
            # pump() below is the re-dial attempt.
            socks = {a._sock: a for a in self.agents.values()
                     if a._sock is not None}
            try:
                ready, _, _ = select.select(list(socks), [], [], 0.2)
            except (OSError, ValueError):
                ready = list(socks)
            n = 0
            for a in self.agents.values():
                if a._sock is not None and (
                        a._sock in ready or a._conn._buf
                        or getattr(a._sock, "pending", lambda: 0)()):
                    n += a.pump()
                else:
                    n += a.pump(wait=0.0)  # drain/reconnect-only, no wait
            self._server.pump()  # consume the freshly-sent status frames
            return n
        return sum(a.pump() for a in self.agents.values())

    def total_events(self) -> int:
        return sum(a.events_seen for a in self.agents.values())

    def realization_hist(self) -> Histogram:
        """Fleet-wide realization-latency histogram (per-agent bucket
        counts folded into one bucket space)."""
        merged = Histogram()
        for a in self.agents.values():
            merged.merge(a.realization_hist)
        return merged

    def realization_p99_s(self) -> float:
        """Fleet-wide p99 of controller-commit -> agent-realized latency
        — the measurable form of ROADMAP item 3's soak target (upper-
        bound bucket estimate; 0.0 before any stamped event)."""
        return self.realization_hist().quantile(0.99)

    def realization_unstamped_total(self) -> int:
        return sum(a.realization_unstamped for a in self.agents.values())

    def policies_on(self, node: str) -> set:
        return set(self.agents[node].policies)

    def queue_stats(self) -> dict:
        """Per-node watcher depth/overflow/coalesce view, transport-blind:
        netwire reads the server's dissemination_stats(); inproc reads the
        store watchers directly.  The storm soak polls this every cycle to
        assert boundedness."""
        if self.transport == "netwire":
            return self._server.dissemination_stats()
        watchers = {
            n: {
                "pending": a._watcher.pending(),
                "overflows": a._watcher.overflows,
                "coalesced": a._watcher.coalesced,
                "needs_resync": a._watcher.needs_resync,
            }
            for n, a in self.agents.items()
        }
        return {
            "watchers": watchers,
            "resyncs_total": sum(a.resyncs_seen
                                 for a in self.agents.values()),
            "reconnects_total": 0,
            "resync_chunks_total": 0,
            "resyncs_inflight": 0,
            "resyncs_shed_total": 0,
            "coalesced_total": sum(w["coalesced"]
                                   for w in watchers.values()),
        }

    def resyncs_seen_total(self) -> int:
        return sum(a.resyncs_seen for a in self.agents.values())

    def stop(self) -> None:
        for a in self.agents.values():
            a.stop()


# -- policy-churn storm soak -------------------------------------------------


def _storm_policy(uid: str, cidr: str, priority: float = 5.0):
    """One storm policy: applied to app=web (so its span covers every node
    hosting a web pod — the soak worlds place one per node), denying one
    rotating ip_block.  Rewrites churn the cidr: same key, new payload."""
    from ..apis import controlplane as cp
    from ..apis import crd

    return crd.AntreaNetworkPolicy(
        uid=uid, name=uid, namespace="", tier_priority=250,
        priority=priority,
        applied_to=[crd.AntreaAppliedTo(
            pod_selector=crd.LabelSelector.make({"app": "web"}),
            ns_selector=crd.LabelSelector.make())],
        rules=[crd.AntreaNPRule(
            direction=cp.Direction.IN, action=cp.RuleAction.DROP,
            peers=[crd.AntreaPeer(ip_block=crd.IPBlock(cidr))])],
    )


def fleet_converged(ctl, fleet, nodes) -> bool:
    """Span-exact convergence against the controller's policy_set_for_node
    oracle: per node, the agent's uid/group-name sets AND per-policy
    generations match (generation parity pins latest-wins coalescing —
    a stale buffered payload would show as a lagging generation)."""
    for node in nodes:
        want = ctl.policy_set_for_node(node)
        a = fleet.agents[node]
        if {p.uid: getattr(p, "generation", 0) for p in want.policies} != {
                u: getattr(p, "generation", 0)
                for u, p in a.policies.items()}:
            return False
        if set(a.address_groups) != set(want.address_groups):
            return False
        if set(a.applied_to_groups) != set(want.applied_to_groups):
            return False
    return True


def run_churn_storm(ctl, fleet, nodes, *, rounds: int, churn: int,
                    rewrites: Optional[int] = None,
                    cap: Optional[int] = None,
                    resync_concurrency: Optional[int] = None,
                    max_cycles: int = 400) -> dict:
    """Drive `rounds` policy-churn storms through a live fleet and pump to
    span-exact convergence after each, asserting boundedness EVERY cycle.

    One round = `churn` upserts across DISTINCT policy uids (distinct
    watcher-queue keys — when churn > the watcher cap this forces a
    fleet-wide overflow, the designed-to-kill case) followed by `rewrites`
    rewrites of ONE policy (same-key churn a coalescing queue must absorb
    in one slot).  After injecting, the fleet pumps until every node in
    `nodes` matches the policy_set_for_node oracle; each cycle asserts
    that no watcher's pending exceeds `cap` and that the server never runs
    more than `resync_concurrency` resync cursors at once.

    -> meters dict (cycle counts, coalesce/overflow/resync/chunk/shed
    totals, realization p99) for the bench JSON line / test assertions."""
    rewrites = churn * 4 if rewrites is None else rewrites
    meters = {
        "rounds": rounds, "churn": churn, "rewrites": rewrites,
        "cycles": 0, "max_pending_seen": 0, "max_resyncs_inflight": 0,
        "round_cycles": [],
    }
    for r in range(rounds):
        for k in range(churn):
            ctl.upsert_antrea_policy(_storm_policy(
                f"storm-{k}", f"198.{(r + 1) % 8}.{k % 250}.0/24"))
        for j in range(rewrites):
            ctl.upsert_antrea_policy(_storm_policy(
                "storm-0", f"203.0.{j % 250}.0/24"))
        cycles = 0
        while True:
            fleet.pump()
            cycles += 1
            meters["cycles"] += 1
            qs = fleet.queue_stats()
            pend = max((w["pending"] for w in qs["watchers"].values()),
                       default=0)
            meters["max_pending_seen"] = max(
                meters["max_pending_seen"], pend)
            meters["max_resyncs_inflight"] = max(
                meters["max_resyncs_inflight"], qs["resyncs_inflight"])
            if cap is not None and pend > cap:
                raise AssertionError(
                    f"watcher pending {pend} exceeded cap {cap} "
                    f"(round {r}, cycle {cycles})")
            if (resync_concurrency is not None
                    and qs["resyncs_inflight"] > resync_concurrency):
                raise AssertionError(
                    f"{qs['resyncs_inflight']} resyncs in flight exceeds "
                    f"bound {resync_concurrency} (round {r})")
            if fleet_converged(ctl, fleet, nodes):
                break
            if cycles >= max_cycles:
                raise AssertionError(
                    f"storm round {r} did not converge within "
                    f"{max_cycles} pump cycles")
        meters["round_cycles"].append(cycles)
    qs = fleet.queue_stats()
    meters.update({
        "coalesced_total": qs["coalesced_total"],
        "overflows_total": sum(w["overflows"]
                               for w in qs["watchers"].values()),
        "resyncs_total": qs["resyncs_total"],
        "resync_chunks_total": qs["resync_chunks_total"],
        "resyncs_shed_total": qs["resyncs_shed_total"],
        "reconnects_total": qs["reconnects_total"],
        "agent_resyncs_seen": fleet.resyncs_seen_total(),
        "events_total": fleet.total_events(),
        "realization_p99_s": fleet.realization_p99_s(),
        "realization_unstamped_total": fleet.realization_unstamped_total(),
    })
    return meters
