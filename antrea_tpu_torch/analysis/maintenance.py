"""Pass `maintenance` — every background loop runs ONLY via the unified
scheduler (the JAX package's pass of the same id, over the port).

The consolidation guarantee (datapath/maintenance.py) only holds if
no plane grows a private cadence again: a direct call site of the
off-hot-step loop entry points anywhere under antrea_tpu_torch/ outside the
scheduler module re-introduces exactly the plane-vs-plane interleaving
races the scheduler's single serialization point retired.  MAINT_TASKS
must name every consolidated loop, every inventoried task must be
constructed, both engines mix the scheduler in, and the forbidden call
patterns appear only at their allowlisted delegation sites."""

from __future__ import annotations

import ast
import re

from .core import Finding, SourceCache, analysis_pass
from .core import pat_slug as _pat_slug

ENGINES = {
    "datapath/tpuflow.py": "TpuflowDatapath",
    "datapath/oracle_dp.py": "OracleDatapath",
}

REQUIRED_TASKS = {
    "canary", "audit-cursor", "tensor-scrub", "cache-maintain",
    "fqdn-ttl", "degraded-recompile",
}

# pattern -> set of package-relative paths allowed to carry it (the
# scheduler module itself is always exempt).
FORBIDDEN = {
    r"\.canary_scan\(": {"datapath/commit.py"},
    # interface.py: the Datapath base default for maintenance_force_audit
    # — the fallback for audit-capable datapaths WITHOUT a scheduler
    # (nothing to serialize against); both engines override through the
    # mixin, which routes via MaintenanceScheduler.force.
    r"\.audit_scan\(": {"datapath/interface.py"},
    r"\.maintain\(": {"datapath/slowpath/engine.py"},
    r"\.tick\(": {"agent/fqdn.py"},
}


def load_tasks(text: str) -> dict:
    m = re.search(r"^MAINT_TASKS\s*(?::[^=]+)?=\s*(\{.*?^\})", text,
                  re.M | re.S)
    if m is None:
        raise ValueError(
            "datapath/maintenance.py defines no MAINT_TASKS literal")
    return ast.literal_eval(m.group(1))


@analysis_pass("maintenance", "every background loop runs only via the "
                              "unified maintenance scheduler")
def check(src: SourceCache) -> list[Finding]:
    maint_rel = "antrea_tpu_torch/datapath/maintenance.py"
    maint_text = src.text(src.pkg / "datapath" / "maintenance.py")
    if not maint_text:
        return [Finding("maintenance", maint_rel, 0,
                        f"{maint_rel} is missing", obj="missing")]

    def f(reason, obj, path=maint_rel, line=0):
        return Finding("maintenance", path, line, reason, obj=obj)

    try:
        tasks = load_tasks(maint_text)
    except ValueError as e:
        return [f(str(e), "no-task-table")]

    problems: list[Finding] = []
    for name in sorted(REQUIRED_TASKS - set(tasks)):
        problems.append(f(
            f"MAINT_TASKS is missing the consolidated loop {name!r}",
            f"missing-task:{name}"))
    for name, plane in tasks.items():
        if not (isinstance(plane, str) and plane.strip()):
            problems.append(f(
                f"MAINT_TASKS[{name!r}] names no owning plane",
                f"no-plane:{name}"))

    # Every inventoried task must be constructed somewhere in the package.
    ctor = re.compile(r"MaintenanceTask\(\s*\n?\s*[\"']([a-z-]+)[\"']")
    constructed: set[str] = set()
    for p in src.pkg_files():
        constructed |= set(ctor.findall(src.text(p) or ""))
    for name in sorted(set(tasks) - constructed):
        problems.append(f(
            f"MAINT_TASKS names {name!r} but no MaintenanceTask("
            f"\"{name}\", ...) is registered anywhere under antrea_tpu_torch/",
            f"unconstructed:{name}"))

    for relpath, cls in ENGINES.items():
        rel = f"antrea_tpu_torch/{relpath}"
        text = src.text(src.pkg / relpath) or ""
        m = re.search(rf"^class {cls}\(([^)]*)\)", text, re.M | re.S)
        if m is None or "MaintainableDatapath" not in m.group(1):
            problems.append(f(
                f"{rel}: {cls} does not inherit MaintainableDatapath",
                f"no-mixin:{cls}", rel))
        if "_init_maintenance(" not in text:
            problems.append(f(
                f"{rel}: {cls} never calls _init_maintenance",
                f"no-init:{cls}", rel))

    for p in src.pkg_files():
        rel = str(p.relative_to(src.pkg)).replace("\\", "/")
        if rel == "datapath/maintenance.py":
            continue
        text = src.text(p) or ""
        for pat, allowed in FORBIDDEN.items():
            if rel in allowed:
                continue
            for ln, line in enumerate(text.splitlines(), 1):
                stripped = line.strip()
                if stripped.startswith("#"):
                    continue
                if re.search(pat, line):
                    problems.append(f(
                        f"antrea_tpu_torch/{rel}:{ln}: direct background-loop "
                        f"call site ({pat}) outside the maintenance "
                        f"scheduler — register a MaintenanceTask and run "
                        f"it via MaintenanceScheduler.tick() instead",
                        f"rogue:{rel}:{_pat_slug(pat)}",
                        f"antrea_tpu_torch/{rel}", ln))
    return problems
