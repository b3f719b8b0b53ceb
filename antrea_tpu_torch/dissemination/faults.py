"""Fault injection for the dissemination plane: deterministic chaos.

The reference's control plane is hardened by real-world failure (agents
lose the apiserver watch and re-list; reconcilers requeue failed installs).
This module is the harness that proves the SAME properties of this build
without waiting for real faults: a FaultPlan scripts WHEN faults fire, and
thin wrappers (socket / pipe / datapath) decide WHAT a fault does —
connection resets, partial writes, added latency, install failures.  Agent
crashes are injected by the chaos tests themselves (closing sockets /
killing subprocesses); the plan gives them the same deterministic schedule.

Everything is deterministic given the plan's seed: chaos tests are
reproducible, not flaky-by-design (tests/test_chaos_dissemination.py).
"""

from __future__ import annotations

import random
import socket
import time
from dataclasses import dataclass, field
from typing import Optional


class FaultClock:
    """Deterministic steppable clock for the chaos tier.

    Passed as the maintenance scheduler's clock
    (`TpuflowDatapath(..., maint_clock=FaultClock())` /
    `MaintenanceScheduler(clock=...)`), it becomes the ONE notion of
    `now` every consolidated background plane consults — FQDN TTL
    expiry, the degraded-recompile backoff, aging cadence — so a chaos
    test advances time explicitly instead of sleeping, and every
    time-driven plane behavior replays deterministically."""

    def __init__(self, start: int = 0):
        self.now = int(start)

    def advance(self, dt: int = 1) -> int:
        if dt < 0:
            raise ValueError(f"FaultClock is monotonic; got dt={dt}")
        self.now += int(dt)
        return self.now

    def __call__(self) -> int:
        return self.now


class InjectedInstallError(RuntimeError):
    """Raised by FlakyDatapath.install_bundle when the plan fires — a
    stand-in for a real datapath rejecting/timing out a rule install.
    Fires BEFORE the datapath's commit plane is entered, so it models the
    TRANSIENT fault the agent's retry/backoff loop absorbs."""


class InjectedCompileError(RuntimeError):
    """Raised INSIDE the commit plane's compile stage (datapath/commit.py)
    when the plan fires at site f"{name}.compile" — a stand-in for the
    compiler/tensor build rejecting a bundle.  Unlike InjectedInstallError
    this reaches the plane, so it drives the rollback-to-LKG + degraded
    path, not the transient retry path.  (Canary-stage faults at
    f"{name}.canary" surface as synthetic verdict mismatches instead: a
    deterministic miscompile injection.)"""


@dataclass
class _Rule:
    kind: str            # "reset" | "partial" | "delay" | "fail"
    every: int = 0       # fire on every Nth hit of the site (0 = off)
    # Fire once the site's hit count exceeds this; None = off.  Distinct
    # from 0 so after(site, 0) means "from the first hit" — the
    # plan.after(site, plan.hits(site)) idiom on a never-consulted site.
    after: Optional[int] = None
    times: int = -1      # remaining firings (-1 = unlimited)
    prob: float = 0.0    # independent per-hit probability (0 = off)
    delay_s: float = 0.0  # for kind="delay"


@dataclass
class _Injection:
    site: str
    kind: str
    hit: int


class FaultPlan:
    """Scripted fault schedule keyed by named sites.

    A *site* is a string a wrapper consults on every operation, e.g.
    "n1.send", "n1.recv", "n1.install".  Rules attach to sites:

        plan.after("n1.send", 3, "reset")       # 4th send onward: reset once
        plan.every("n1.install", 2, "fail")     # every 2nd install raises
        plan.prob("n2.recv", 0.1, "reset")      # 10% of recvs reset

    fire(site) returns the fault kind to inject (or None) and logs every
    injection in .injected so tests can assert the chaos actually
    happened — a chaos run that injected nothing proves nothing.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self._rules: dict[str, list[_Rule]] = {}
        self._hits: dict[str, int] = {}
        self.injected: list[_Injection] = []
        # Flight recorders (observability/flightrec.py) every injection
        # journals itself into — the chaos tier's cause-beside-effect
        # guarantee: a post-mortem reads "fault-injected" in the same
        # sequence-ordered journal as the rollbacks/repairs it caused.
        self._recorders: list = []

    def bind_recorder(self, recorder) -> "FaultPlan":
        """Attach a FlightRecorder (None is a no-op; duplicates are
        collapsed — a plan arming several planes of ONE datapath must
        journal each injection once)."""
        if recorder is not None and all(r is not recorder
                                        for r in self._recorders):
            self._recorders.append(recorder)
        return self

    def _add(self, site: str, rule: _Rule) -> "FaultPlan":
        self._rules.setdefault(site, []).append(rule)
        return self

    def every(self, site: str, n: int, kind: str = "reset",
              times: int = -1, delay_s: float = 0.0) -> "FaultPlan":
        return self._add(site, _Rule(kind=kind, every=n, times=times,
                                     delay_s=delay_s))

    def after(self, site: str, n: int, kind: str = "reset",
              times: int = 1, delay_s: float = 0.0) -> "FaultPlan":
        return self._add(site, _Rule(kind=kind, after=n, times=times,
                                     delay_s=delay_s))

    def prob(self, site: str, p: float, kind: str = "reset",
             times: int = -1, delay_s: float = 0.0) -> "FaultPlan":
        return self._add(site, _Rule(kind=kind, prob=p, times=times,
                                     delay_s=delay_s))

    def fire(self, site: str) -> Optional[_Rule]:
        """Register one hit of `site`; -> the rule to inject, or None."""
        hit = self._hits.get(site, 0) + 1
        self._hits[site] = hit
        for rule in self._rules.get(site, ()):
            if rule.times == 0:
                continue
            triggered = (
                (rule.every and hit % rule.every == 0)
                or (rule.after is not None and hit > rule.after)
                or (rule.prob and self.rng.random() < rule.prob)
            )
            if triggered:
                if rule.times > 0:
                    rule.times -= 1
                self.injected.append(_Injection(site, rule.kind, hit))
                for rec in self._recorders:
                    rec.emit(kind="fault-injected", site=site,
                             fault=rule.kind, hit=hit)
                return rule
        return None

    def hits(self, site: str) -> int:
        """How many times `site` has been consulted so far — lets a test
        schedule a fault on the NEXT hit: plan.after(site, plan.hits(site),
        kind, times=1)."""
        return self._hits.get(site, 0)

    def quiesce(self) -> None:
        """Drop every rule: the recovery phase of a chaos test asserts
        convergence in calm weather, and an injection firing during the
        parity check would measure the fault, not the healing."""
        self._rules.clear()

    def count(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return len(self.injected)
        return sum(1 for i in self.injected if i.kind == kind)


class FaultySocket:
    """Socket wrapper injecting faults on send/recv per the plan.

    Sites consulted: f"{name}.send" and f"{name}.recv".
      reset   -> close the real socket, raise ConnectionResetError
      partial -> transmit a PREFIX of the payload, then reset (the peer's
                 framing layer must hold the torn line and discard it with
                 the connection, never parse it)
      delay   -> sleep rule.delay_s, then proceed
    Everything else delegates to the wrapped socket.
    """

    def __init__(self, sock, plan: FaultPlan, name: str):
        self._sock = sock
        self._plan = plan
        self._name = name

    def _inject(self, op: str, payload: Optional[bytes] = None):
        rule = self._plan.fire(f"{self._name}.{op}")
        if rule is None:
            return None
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
            return None
        if rule.kind == "partial" and payload:
            try:
                self._sock.sendall(payload[: max(1, len(payload) // 2)])
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        raise ConnectionResetError(
            f"injected {rule.kind} on {self._name}.{op}")

    def sendall(self, data: bytes) -> None:
        self._inject("send", data)
        self._sock.sendall(data)

    def send(self, data: bytes) -> int:
        self._inject("send", data)
        return self._sock.send(data)

    def recv(self, n: int) -> bytes:
        self._inject("recv")
        return self._sock.recv(n)

    def fileno(self) -> int:
        # select() needs the REAL fd even after an injected close (it
        # returns -1 then; callers treat that as dead).
        return self._sock.fileno()

    def __getattr__(self, item):
        return getattr(self._sock, item)


class FaultyPipe:
    """File-like write wrapper for the pipe transport (site f"{name}.write"):
    reset -> close the pipe and raise BrokenPipeError mid-stream; partial
    -> write a prefix first.  Wraps e.g. SubprocessAgent._proc.stdin."""

    def __init__(self, pipe, plan: FaultPlan, name: str):
        self._pipe = pipe
        self._plan = plan
        self._name = name

    def write(self, data: bytes) -> int:
        rule = self._plan.fire(f"{self._name}.write")
        if rule is not None:
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            else:
                if rule.kind == "partial" and data:
                    try:
                        self._pipe.write(data[: max(1, len(data) // 2)])
                        self._pipe.flush()
                    except OSError:
                        pass
                try:
                    self._pipe.close()
                except OSError:
                    pass
                raise BrokenPipeError(
                    f"injected {rule.kind} on {self._name}.write")
        return self._pipe.write(data)

    def __getattr__(self, item):
        return getattr(self._pipe, item)


class FlakyDatapath:
    """Datapath wrapper whose install_bundle raises per the plan (site
    f"{name}.install") — drives the agent's install-retry path.  All other
    datapath behavior (step/trace/stats/...) passes through, so verdict
    parity checks run against the real datapath underneath.

    Wrapping a transactional datapath (datapath/commit.py) also arms the
    commit plane's OWN fault sites from the same plan — f"{name}.compile"
    (raises InjectedCompileError inside the compile stage) and
    f"{name}.canary" (forces a canary mismatch) — so one plan scripts both
    the transient-install faults outside the plane and the
    rollback-forcing faults inside it.

    An auditable datapath (datapath/audit.py) additionally gets its
    revalidator sites armed: f"{name}.cache" REALLY corrupts live state
    before an audit scan runs (kind "partial" flips one rule-side tensor
    word — the canary-blind service-table class; any other kind flips a
    sampled cached verdict bit), and f"{name}.audit" forces a
    false-positive divergence finding — so the chaos tier can prove
    corruption -> detection -> repair -> reconvergence deterministically.

    A mesh datapath with the replica-loss failover plane enabled
    (parallel/failover.py) gets its health-probe sites armed too:
    f"{name}.replica_dead" makes the targeted data replica's probe row
    read as diverged (the rule KIND names the replica — "r1"; anything
    else targets replica 0), and f"{name}.replica_wedge" rides the
    rule's delay_s onto that replica's measured probe latency so it
    blows the probe deadline — so replica death is deterministic in
    chaos tests, never a real device kill."""

    def __init__(self, inner, plan: FaultPlan, name: str):
        self._inner = inner
        self._plan = plan
        self._name = name
        for arm_name in ("arm_commit_faults", "arm_audit_faults",
                         "arm_failover_faults"):
            arm = getattr(inner, arm_name, None)
            if arm is not None:
                arm(plan, name)
        # Chaos post-mortems: injections at the wrapper's OWN site
        # ({name}.install) journal into the inner datapath's recorder
        # too, not only the in-plane compile/canary/cache/audit sites.
        plan.bind_recorder(getattr(inner, "_flightrec", None))

    def install_bundle(self, *a, **kw):
        rule = self._plan.fire(f"{self._name}.install")
        if rule is not None and rule.kind != "delay":
            raise InjectedInstallError(
                f"injected install failure on {self._name}")
        return self._inner.install_bundle(*a, **kw)

    def __getattr__(self, item):
        return getattr(self._inner, item)
