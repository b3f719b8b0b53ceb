"""Pass `tenant` — every 5-tuple-keyed or per-world surface carries the
tenant id (the JAX package's pass of the same id, over the port).

A multi-tenant datapath is only isolated if NO surface that hashes,
keys, or commits on the 5-tuple can silently drop the owning world:
the miss-queue schema carries the tenant column, every _queue_cols /
shard_of_tuples call site passes tenant= (or is allowlisted with a
reason), each engine's _TENANT_WORLD_FIELDS covers the required
per-world members, the commit plane's per-world slice names real
CommitPlane attributes, and every tenant metric family renders
tenant-labeled."""

from __future__ import annotations

import ast
import pathlib
import re

from .core import Finding, SourceCache, analysis_pass

# shard_of_tuples call sites allowed WITHOUT a tenant= kwarg, with the
# reason each is default-world-only by construction.
SHARD_ALLOWLIST = {
    "parallel/mesh.py":
        "the definition site (tenant defaults to 0 = the default world)",
}

# _queue_cols call sites allowed WITHOUT tenant= (the definition).
QUEUE_ALLOWLIST = {
    "datapath/interface.py":
        "the definition site (tenant defaults to 0)",
}

REQUIRED_WORLD_FIELDS = {
    "datapath/tpuflow.py": {
        "_ps", "_cps", "_drs", "_meta", "_meta_step", "_state", "_gen",
        "_stats_in", "_stats_out", "_evictions", "_state_mutations",
        "_pipe_kw",
    },
    "datapath/oracle_dp.py": {
        "_ps", "_oracle", "_gen", "_stats_in", "_stats_out",
        "_state_mutations",
    },
}

REQUIRED_COMMIT_FIELDS = {"degraded", "last_error", "lkg_generation",
                          "lkg_at"}


def _literal_tuple(src: SourceCache, path: pathlib.Path, name: str):
    text = src.text(path)
    if text is None:
        raise ValueError(f"{src.rel(path)} is missing")
    m = re.search(rf"^\s*{name}\s*(?::[^=]+)?=\s*(\(.*?\))", text,
                  re.M | re.S)
    if m is None:
        raise ValueError(f"{src.rel(path)} defines no {name} literal")
    return ast.literal_eval(m.group(1))


def _call_sites(src: SourceCache, pattern: str) -> list[tuple[str, int, str]]:
    """(pkg-relative path, lineno, full call text) of every `pattern(`
    site — the call text spans to the balanced closing paren."""
    out = []
    rx = re.compile(re.escape(pattern) + r"\(")
    for p in src.pkg_files():
        text = src.text(p) or ""
        rel = str(p.relative_to(src.pkg)).replace("\\", "/")
        for m in rx.finditer(text):
            start = m.end() - 1
            depth = 0
            for i in range(start, min(len(text), start + 2000)):
                if text[i] == "(":
                    depth += 1
                elif text[i] == ")":
                    depth -= 1
                    if depth == 0:
                        break
            line = text.count("\n", 0, m.start()) + 1
            out.append((rel, line, text[m.start():i + 1]))
    return out


@analysis_pass("tenant", "every 5-tuple-keyed or per-world surface carries "
                         "the tenant id")
def check(src: SourceCache) -> list[Finding]:
    problems: list[Finding] = []

    def f(reason, obj, path, line=0):
        return Finding("tenant", path, line, reason, obj=obj)

    # 1. queue schema + builder.
    queue_rel = "antrea_tpu_torch/datapath/slowpath/queue.py"
    qtext = src.text(src.pkg / "datapath" / "slowpath" / "queue.py") or ""
    m = re.search(r"^COLUMNS\s*=\s*(\(.*?\))", qtext, re.M | re.S)
    cols = ast.literal_eval(m.group(1)) if m else ()
    if "tenant" not in cols:
        problems.append(f(
            "datapath/slowpath/queue.COLUMNS has no 'tenant' column — "
            "queued misses cannot be classified in their owner's world",
            "no-tenant-column", queue_rel))
    itext = src.text(src.pkg / "datapath" / "interface.py") or ""
    if '"tenant"' not in itext:
        problems.append(f(
            "datapath/interface._queue_cols does not produce the "
            "'tenant' column", "no-tenant-builder",
            "antrea_tpu_torch/datapath/interface.py"))

    # 2./3. call sites must pass tenant=.
    for pattern, allow, why in (
        ("_queue_cols", QUEUE_ALLOWLIST,
         "queued rows would land in the default world"),
        ("shard_of_tuples", SHARD_ALLOWLIST,
         "two tenants' identical tuples would share one home"),
    ):
        for rel, line, call in _call_sites(src, pattern):
            if rel in allow:
                continue
            if re.search(r"def\s+" + pattern, call):
                continue
            if "tenant=" not in call:
                problems.append(f(
                    f"{rel}:{line}: {pattern}(...) drops the tenant id "
                    f"({why}) — pass tenant= or allowlist with a reason",
                    f"dropped:{pattern}:{rel}",
                    f"antrea_tpu_torch/{rel}", line))

    # 4. world-field coverage.
    for relpath, required in REQUIRED_WORLD_FIELDS.items():
        rel = f"antrea_tpu_torch/{relpath}"
        try:
            fields = set(_literal_tuple(src, src.pkg / relpath,
                                        "_TENANT_WORLD_FIELDS"))
        except ValueError as e:
            problems.append(f(str(e), f"no-world-fields:{relpath}", rel))
            continue
        for name in sorted(required - fields):
            problems.append(f(
                f"{rel}: _TENANT_WORLD_FIELDS is missing {name!r} — that "
                f"state would leak across world swaps",
                f"world-field:{relpath}:{name}", rel))

    # 5. commit-plane slice.
    tenancy_rel = "antrea_tpu_torch/datapath/tenancy.py"
    try:
        cw = set(_literal_tuple(src, src.pkg / "datapath" / "tenancy.py",
                                "COMMIT_WORLD_FIELDS"))
    except ValueError as e:
        problems.append(f(str(e), "no-commit-fields", tenancy_rel))
        cw = set()
    for name in sorted(REQUIRED_COMMIT_FIELDS - cw):
        problems.append(f(
            f"datapath/tenancy.COMMIT_WORLD_FIELDS is missing {name!r} — "
            f"a tenant rollback would not be tenant-scoped",
            f"commit-field:{name}", tenancy_rel))
    commit_text = src.text(src.pkg / "datapath" / "commit.py") or ""
    for name in sorted(cw):
        if not re.search(rf"self\.{name}\b", commit_text):
            problems.append(f(
                f"COMMIT_WORLD_FIELDS names {name!r} but CommitPlane has "
                f"no such attribute — the swap would silently no-op",
                f"commit-attr:{name}", "antrea_tpu_torch/datapath/commit.py"))

    # 6. tenant metric families render tenant-labeled.
    metrics_rel = "antrea_tpu_torch/observability/metrics.py"
    mtext = src.text(src.pkg / "observability" / "metrics.py") or ""
    m = re.search(r"^METRICS\s*(?::[^=]+)?=\s*(\{.*?^\})", mtext,
                  re.M | re.S)
    registry = ast.literal_eval(m.group(1)) if m else {}
    tenant_fams = [n for n in registry
                   if n.startswith("antrea_tpu_tenant_")
                   and n != "antrea_tpu_tenant_worlds"]
    if not tenant_fams:
        problems.append(f(
            "no antrea_tpu_tenant_* families in the metrics registry",
            "no-tenant-families", metrics_rel))
    if "_labels(tenant=tid, node=node)" not in mtext:
        problems.append(f(
            "observability/metrics.py renders no tenant-labeled sample "
            "lines (_labels(tenant=...)) — tenant meters would "
            "aggregate worlds together", "unlabeled-render", metrics_rel))
    return problems
