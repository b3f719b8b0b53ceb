"""Pass `commit-plane` — every install routes through datapath/commit.py
(the JAX package's pass of the same id, over the port).

The self-healing guarantees of the transactional commit plane (compile
-> canary -> atomic swap -> settle, rollback to last-known-good,
degraded mode) hold only if NO datapath exposes a tensor-swap entry
point that bypasses the plane: engines must not define the public
install_bundle/apply_group_delta themselves, nothing may call an
`_impl` hook outside commit.py, engines must inherit
TransactionalDatapath, and no engine impl performs its own settle."""

from __future__ import annotations

import re

from .core import Finding, SourceCache, analysis_pass
from .core import pat_slug as _pat_slug

ENGINE_CLASSES = {
    "datapath/tpuflow.py": "TpuflowDatapath",
    "datapath/oracle_dp.py": "OracleDatapath",
}
PUBLIC = ("install_bundle", "apply_group_delta")
IMPLS = ("_install_bundle_impl", "_apply_group_delta_impl")
SETTLE = (r"self\._persist\(\)", r"self\._record_round\(\)")


@analysis_pass("commit-plane", "every bundle install routes through the "
                               "transactional commit plane's canary gate")
def check(src: SourceCache) -> list[Finding]:
    commit_rel = "antrea_tpu_torch/datapath/commit.py"
    commit_text = src.text(src.pkg / "datapath" / "commit.py")
    if not commit_text:
        return [Finding("commit-plane", commit_rel, 0,
                        f"{commit_rel} is missing", obj="missing")]

    problems: list[Finding] = []

    def f(reason, obj, path, line=0):
        return Finding("commit-plane", path, line, reason, obj=obj)

    # 1 + 3 + 4: per-engine rules.
    for relpath, cls in ENGINE_CLASSES.items():
        path = src.pkg / relpath
        rel = f"antrea_tpu_torch/{relpath}"
        text = src.text(path) or ""
        for name in PUBLIC:
            if re.search(rf"^\s*def {name}\(", text, re.M):
                problems.append(f(
                    f"{rel} defines public {name}() — installs must route "
                    f"through the commit plane (datapath/commit.py)",
                    f"public:{relpath}:{name}", rel))
        for name in IMPLS:
            if not re.search(rf"^\s*def {name}\(", text, re.M):
                problems.append(f(
                    f"{rel} does not implement {name}()",
                    f"no-impl:{relpath}:{name}", rel))
        m = re.search(rf"^class {cls}\(([^)]*)\)", text, re.M | re.S)
        if m is None or "TransactionalDatapath" not in m.group(1):
            problems.append(f(
                f"{rel}: {cls} does not inherit TransactionalDatapath",
                f"no-mixin:{cls}", rel))
        for pat in SETTLE:
            for ln, line in enumerate(text.splitlines(), 1):
                if re.search(pat, line) and not line.lstrip().startswith("#"):
                    problems.append(f(
                        f"{rel}:{ln} settles its own persistence "
                        f"({pat.replace(chr(92), '')}) — settle belongs to "
                        f"the commit plane, after the canary",
                        f"self-settle:{relpath}:{_pat_slug(pat)}", rel, ln))

    # 2: _impl call sites only inside commit.py.
    for path in src.pkg_files():
        rel = src.rel(path)
        if rel == commit_rel:
            continue
        text = src.text(path) or ""
        for name in IMPLS:
            for ln, line in enumerate(text.splitlines(), 1):
                if f"{name}(" not in line:
                    continue
                stripped = line.lstrip()
                if stripped.startswith(("def ", "#")):
                    continue  # the definition / commentary, not a call
                problems.append(f(
                    f"{rel}:{ln} calls {name}() outside datapath/commit.py "
                    f"— a tensor swap bypassing the canary gate",
                    f"bypass:{rel}:{name}", rel, ln))

    # The mixin really carries the public surface.
    for name in PUBLIC:
        if not re.search(rf"^\s*def {name}\(", commit_text, re.M):
            problems.append(f(
                f"datapath/commit.py defines no {name}()",
                f"mixin-missing:{name}", commit_rel))
    return problems
