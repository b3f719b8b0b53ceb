"""Pass `audit-plane` — every mutable tensor is scrubbed or waived
(the JAX package's pass of the same id, over the port).

The checksum scrub (datapath/audit.py mechanism 2) only protects what
it digests.  The authoritative inventory of everything a commit can
touch is `_commit_snapshot` on the two engines — a snapshot key must be
covered by SCRUB_MANIFEST ("rule" | "state") or waived with a reason in
SCRUB_ALLOWLIST; SCRUB_SUBTENSORS stays consistent with
ops/match.DimTable.agg; engines implement the scrub hooks and inherit
AuditableDatapath."""

from __future__ import annotations

import ast
import re

from .core import Finding, SourceCache, analysis_pass

ENGINE_CLASSES = {
    "datapath/tpuflow.py": "TpuflowDatapath",
    "datapath/oracle_dp.py": "OracleDatapath",
}
HOOKS = ("_audit_rule_digests", "_audit_state_digest", "_audit_reupload",
         "_audit_window", "_audit_fresh", "_audit_evict")

_DICT_LITERAL = r"^{name}\s*(?::[^=]+)?=\s*(\{{.*?^\}})"


def load_table(text: str, name: str) -> dict:
    """Extract + literal-eval a module-level dict assignment from audit.py
    (pure literals by contract — the docstring on the tables says so)."""
    m = re.search(_DICT_LITERAL.format(name=name), text, re.M | re.S)
    if m is None:
        raise ValueError(f"datapath/audit.py defines no {name} literal")
    return ast.literal_eval(m.group(1))


def snapshot_keys(text: str, name: str) -> list[str]:
    """String keys of the dict `_commit_snapshot` returns."""
    m = re.search(r"def _commit_snapshot\(.*?(?=\n    def )", text, re.S)
    if m is None:
        raise ValueError(f"{name}: no _commit_snapshot found")
    body = m.group(0)
    ret = body[body.index("return {"):]
    return re.findall(r'^\s*"(\w+)":', ret, re.M)


@analysis_pass("audit-plane", "every commit-snapshot tensor is checksum-"
                              "scrubbed or waived with a reason")
def check(src: SourceCache) -> list[Finding]:
    audit_rel = "antrea_tpu_torch/datapath/audit.py"
    audit_text = src.text(src.pkg / "datapath" / "audit.py")
    if not audit_text:
        return [Finding("audit-plane", audit_rel, 0,
                        f"{audit_rel} is missing", obj="missing")]

    def f(reason, obj, path=audit_rel, line=0):
        return Finding("audit-plane", path, line, reason, obj=obj)

    try:
        manifest = load_table(audit_text, "SCRUB_MANIFEST")
        allowlist = load_table(audit_text, "SCRUB_ALLOWLIST")
    except ValueError as e:
        return [f(str(e), "tables-unreadable")]

    problems: list[Finding] = []
    for key, klass in manifest.items():
        if klass not in ("rule", "state"):
            problems.append(f(
                f"SCRUB_MANIFEST[{key!r}] = {klass!r} — must be 'rule' or "
                f"'state'", f"bad-class:{key}"))
    for key, reason in allowlist.items():
        if not (isinstance(reason, str) and reason.strip()):
            problems.append(f(
                f"SCRUB_ALLOWLIST[{key!r}] has no reason — every waived "
                f"snapshot key must say WHY it needs no scrub",
                f"no-reason:{key}"))
    for key in set(manifest) & set(allowlist):
        problems.append(f(
            f"{key!r} is both scrubbed (SCRUB_MANIFEST) and waived "
            f"(SCRUB_ALLOWLIST) — pick one", f"both:{key}"))

    # Round-7 aggregate tables: while DimTable carries an `agg` field the
    # SUB-tensor table must carry its "drs.agg" row (a corrupt aggregate
    # bit can flip a verdict — see the SCRUB_SUBTENSORS comment; it rides
    # the `drs` digest, so it must NOT be a manifest row, which would
    # inflate the maintenance scheduler's scrub cost) and vice versa (a
    # stale row must not outlive the field).
    try:
        subtensors = load_table(audit_text, "SCRUB_SUBTENSORS")
    except ValueError as e:
        return problems + [f(str(e), "subtensors-unreadable")]
    for key in set(subtensors) & set(manifest):
        problems.append(f(
            f"{key!r} is in both SCRUB_MANIFEST and SCRUB_SUBTENSORS — "
            f"sub-tensors ride a group digest, they are not extra folds",
            f"sub-and-manifest:{key}"))
    match_text = src.text(src.pkg / "ops" / "match.py") or ""
    dim_cls = re.search(r"^class DimTable\(.*?(?=^class |^def )",
                        match_text, re.M | re.S)
    has_agg_field = bool(dim_cls) and bool(
        re.search(r"^    agg\s*:", dim_cls.group(0), re.M))
    if has_agg_field and "drs.agg" not in subtensors:
        problems.append(f(
            "ops/match.DimTable declares `agg` but SCRUB_SUBTENSORS has "
            "no 'drs.agg' row — aggregate/table divergence would go "
            "undocumented/ungated", "agg-unlisted"))
    if not has_agg_field and "drs.agg" in subtensors:
        problems.append(f(
            "SCRUB_SUBTENSORS carries 'drs.agg' but ops/match.DimTable "
            "declares no `agg` field — stale row", "agg-stale"))

    for relpath, cls in ENGINE_CLASSES.items():
        path = src.pkg / relpath
        rel = f"antrea_tpu_torch/{relpath}"
        text = src.text(path) or ""
        try:
            keys = snapshot_keys(text, relpath)
        except ValueError as e:
            problems.append(f(str(e), f"snapshot-unreadable:{relpath}", rel))
            continue
        if not keys:
            problems.append(f(f"{rel}: _commit_snapshot returns no keys?",
                              f"snapshot-empty:{relpath}", rel))
        for key in keys:
            if key not in manifest and key not in allowlist:
                problems.append(f(
                    f"{rel}: _commit_snapshot key {key!r} is neither in "
                    f"SCRUB_MANIFEST nor SCRUB_ALLOWLIST — new state must "
                    f"be checksum-scrubbed or explicitly waived with a "
                    f"reason (datapath/audit.py)",
                    f"uncovered:{relpath}:{key}", rel))
        m = re.search(rf"^class {cls}\(([^)]*)\)", text, re.M | re.S)
        if m is None or "AuditableDatapath" not in m.group(1):
            problems.append(f(
                f"{rel}: {cls} does not inherit AuditableDatapath",
                f"no-mixin:{cls}", rel))
        for hook in HOOKS:
            if not re.search(rf"^\s*def {hook}\(", text, re.M):
                problems.append(f(f"{rel} does not implement {hook}()",
                                  f"no-hook:{relpath}:{hook}", rel))
    return problems
