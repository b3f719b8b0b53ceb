"""Pass `events` — flight-recorder / realization-tracing drift
(the JAX package's pass of the same id, over the port).

The post-mortem journal is only trustworthy if its schema, its emit
sites and its operator documentation agree: every literal emit kind is
declared in flightrec.EVENT_KINDS, every declared kind has >= 1 emit
site and a README row, and the realization stage labels each have a
README row with the antrea_tpu_policy_realization_seconds family
registered."""

from __future__ import annotations

import ast
import pathlib
import re

from .core import Finding, SourceCache, analysis_pass

# Emit call sites carrying a LITERAL kind: the recorder's own keyword
# form and the planes' positional `_emit("kind", ...)` helpers.
EMIT_RES = (
    re.compile(r"\.emit\(\s*kind=\"([a-z0-9-]+)\""),
    re.compile(r"\._emit\(\s*\"([a-z0-9-]+)\""),
)


def _literal(src: SourceCache, path: pathlib.Path, name: str):
    """Evaluate a module-level literal assignment without importing."""
    text = src.text(path)
    if text is None:
        raise ValueError(f"{src.rel(path)} is missing")
    m = re.search(rf"^{name}\s*(?::[^=]+)?=\s*(\{{.*?^\}}|\(.*?^\))", text,
                  re.M | re.S)
    if m is None:
        raise ValueError(f"{src.rel(path)} defines no {name} literal")
    return ast.literal_eval(m.group(1))


def emit_sites(src: SourceCache) -> dict:
    """kind -> [package-relative paths with a literal emit of it]."""
    out: dict[str, list[str]] = {}
    for p in src.pkg_files():
        text = src.text(p) or ""
        for rx in EMIT_RES:
            for kind in rx.findall(text):
                out.setdefault(kind, []).append(src.rel(p))
    return out


@analysis_pass("events", "journal schema == emit sites == README event "
                         "and span tables")
def check(src: SourceCache) -> list[Finding]:
    flightrec_rel = "antrea_tpu_torch/observability/flightrec.py"
    tracing_rel = "antrea_tpu_torch/observability/tracing.py"

    def f(reason, obj, path=flightrec_rel):
        return Finding("events", path, 0, reason, obj=obj)

    try:
        kinds = _literal(src, src.pkg / "observability" / "flightrec.py",
                         "EVENT_KINDS")
        stages = _literal(src, src.pkg / "observability" / "tracing.py",
                          "REALIZATION_STAGES")
        registry = _literal(src, src.pkg / "observability" / "metrics.py",
                            "METRICS")
    except (OSError, ValueError) as e:
        return [f(str(e), "literal-unreadable")]
    readme = src.text(src.root / "README.md") or ""

    problems: list[Finding] = []
    sites = emit_sites(src)
    for kind in sorted(set(sites) - set(kinds)):
        problems.append(f(
            f"emit site uses undeclared kind {kind!r} "
            f"({', '.join(sites[kind])}) — declare it in EVENT_KINDS",
            f"undeclared:{kind}"))
    for kind in sorted(set(kinds) - set(sites)):
        problems.append(f(
            f"declared kind {kind!r} has no emit site under antrea_tpu_torch/ — "
            f"dead schema row", f"dead:{kind}"))
    for kind in sorted(kinds):
        if f"`{kind}`" not in readme:
            problems.append(f(
                f"declared kind {kind!r} has no README row (event-kind "
                f"table in the Observability section)",
                f"undocumented:{kind}", "README.md"))

    fam = "antrea_tpu_policy_realization_seconds"
    if fam not in registry:
        problems.append(f(
            f"{fam} is not registered in observability/metrics.METRICS",
            "realization-family-unregistered",
            "antrea_tpu_torch/observability/metrics.py"))
    if fam not in readme:
        problems.append(f(f"{fam} has no README row",
                          "realization-family-undocumented", "README.md"))
    for stage in stages:
        if f"`{stage}`" not in readme:
            problems.append(f(
                f"realization stage {stage!r} has no README row "
                f"(span-stage table in the Observability section)",
                f"stage-undocumented:{stage}", tracing_rel))
    return problems
