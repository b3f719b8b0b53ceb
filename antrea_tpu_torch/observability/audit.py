"""NetworkPolicy audit logging with dedup buffering.

The analog of the reference's NP audit logger
(pkg/agent/controller/networkpolicy/audit_logging.go:48-171):
enforced deny/reject verdicts become append-only log records; identical
records inside a buffer window aggregate into one line with a packet count
(the reference's logDedupRecord buffering, flushed after a dedup interval).

Record format mirrors the reference's fields (antrea-network-policy log):
  <ts> <rule|DefaultDeny> <verdict> <reject-kind> <src>:<sport> -> <dst>:<dport> proto <p> x<count>

Driven from StepResult batches at the Datapath boundary, so both datapath
implementations feed the same logger — and an audit parity test can diff
the records the two produce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils import ip as iputil

_VERDICT = {1: "Drop", 2: "Reject"}
_RK = {0: "", 1: "tcp-rst", 2: "icmp-unreach"}


def deny_rule_ids(ps) -> set:
    """Rule ids whose action is Drop/Reject — the attribution filter: a
    denied packet's StepResult carries BOTH directions' deciding rules, and
    only a deny-action rule can be the denier (an opposite-direction Allow
    attribution must not be logged as the denying rule)."""
    from ..apis.controlplane import RuleAction
    from ..compiler.ir import rule_id

    out: set = set()
    for p in ps.policies:
        for i, r in enumerate(p.rules):
            if r.action in (RuleAction.DROP, RuleAction.REJECT):
                out.add(rule_id(p, i))
    return out


@dataclass
class _Pending:
    first_ts: int
    last_ts: int
    count: int


@dataclass
class AuditRecord:
    ts: int
    rule: str  # stable rule id or "DefaultDeny"
    verdict: str
    reject_kind: str
    src_ip: int
    src_port: int
    dst_ip: int
    dst_port: int
    proto: int
    count: int

    def line(self) -> str:
        rk = f" {self.reject_kind}" if self.reject_kind else ""
        return (
            f"{self.ts} {self.rule} {self.verdict}{rk} "
            f"{iputil.u32_to_ip(self.src_ip)}:{self.src_port} -> "
            f"{iputil.u32_to_ip(self.dst_ip)}:{self.dst_port} "
            f"proto {self.proto} x{self.count}"
        )


class AuditLogger:
    """Dedup-buffered deny/reject audit stream.

    observe() ingests a StepResult; identical (5-tuple, verdict, rule)
    records within `dedup_s` aggregate.  flush() emits matured records (or
    everything with force=True) in deterministic order.
    """

    def __init__(
        self,
        dedup_s: int = 5,
        path: Optional[str] = None,
        deny_rules: Optional[set] = None,
        feature_gates=None,
    ):
        if feature_gates is not None and not feature_gates.enabled("AuditLogging"):
            raise RuntimeError("AuditLogging feature gate is disabled")
        self.dedup_s = dedup_s
        self.path = path
        # See deny_rule_ids(); update via set_deny_rules on bundle changes.
        self.deny_rules = deny_rules
        self._pending: dict[tuple, _Pending] = {}
        self.records: list[AuditRecord] = []
        self._unwritten: list[AuditRecord] = []

    def set_deny_rules(self, deny_rules: set) -> None:
        self.deny_rules = deny_rules

    def _attribute(self, ingress_rule, egress_rule) -> str:
        if self.deny_rules is None:
            # Without the deny-action index, named attribution is unsafe:
            # the only populated attribution may be an ALLOW rule of the
            # direction that did NOT deny (e.g. egress default-deny + an
            # ingress allow).  Callers wanting rule names pass
            # deny_rules=deny_rule_ids(ps).
            return "DefaultDeny"
        for r in (ingress_rule, egress_rule):
            if r and r in self.deny_rules:
                return r
        return "DefaultDeny"

    def observe(self, batch, result, now: int) -> None:
        # Hot path: the common all-allowed batch must not pay a Python loop.
        denied = np.flatnonzero(np.asarray(result.code))
        for i in denied:
            i = int(i)
            code = int(result.code[i])
            rule = self._attribute(result.ingress_rule[i], result.egress_rule[i])
            key = (
                rule, code, int(result.reject_kind[i]),
                int(batch.src_ip[i]), int(batch.src_port[i]),
                int(batch.dst_ip[i]), int(batch.dst_port[i]),
                int(batch.proto[i]),
            )
            p = self._pending.get(key)
            if p is not None and now - p.first_ts <= self.dedup_s:
                p.count += 1
                p.last_ts = now
            else:
                if p is not None:
                    self._emit(key, p)
                self._pending[key] = _Pending(first_ts=now, last_ts=now, count=1)
        self._write_out()

    def _emit(self, key: tuple, p: _Pending) -> None:
        rule, code, rk, sip, sp, dip, dp, proto = key
        rec = AuditRecord(
            ts=p.first_ts, rule=rule, verdict=_VERDICT.get(code, str(code)),
            reject_kind=_RK.get(rk, str(rk)), src_ip=sip, src_port=sp,
            dst_ip=dip, dst_port=dp, proto=proto, count=p.count,
        )
        self.records.append(rec)
        if self.path is not None:
            self._unwritten.append(rec)

    def _write_out(self) -> None:
        """One open per batch of emissions, not per record."""
        if self.path is None or not self._unwritten:
            return
        with open(self.path, "a") as f:
            for rec in self._unwritten:
                f.write(rec.line() + "\n")
        self._unwritten.clear()

    def flush(self, now: int, force: bool = False) -> list[AuditRecord]:
        """Emit records whose dedup window has matured; returns them."""
        start = len(self.records)
        for key in sorted(self._pending):
            p = self._pending[key]
            if force or now - p.first_ts > self.dedup_s:
                self._emit(key, p)
                del self._pending[key]
        self._write_out()
        return self.records[start:]
