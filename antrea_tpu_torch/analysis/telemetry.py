"""Pass `telemetry-registry` — hot-path telemetry schema drift.

The telemetry plane spans four layers that must agree on ONE counter
schema: the kernel's `tel_*` outputs (models/pipeline.py), the
TelemetryPlane accumulator literal (observability/telemetry.py
TELEMETRY_COUNTERS — the plane builds its counter dict from it, so the
literal IS the accumulator set), the registered metric families
(observability/metrics.METRICS `antrea_tpu_telemetry_<name>_total`),
and the operator documentation (README counter table).  A counter added
in any one layer without the other three silently renders as zero or
scrapes as an unregistered family — this pass fails the build instead.
Regime names (REGIMES) must likewise each carry a README row, and the
sentinel's histogram/regression families must stay registered.

Adapted from the JAX package's pass of the same id: a kernel emit site is
a quoted `"tel_<name>"` key OR a `tel_<name>=` keyword (the port's step
emits two counters as `out.update(tel, tel_dma_hb=..., ...)`); the JAX
pattern knows the quoted form only."""

from __future__ import annotations

import ast
import re

from .core import Finding, SourceCache, analysis_pass
from .events import _literal

TELEMETRY_REL = "antrea_tpu_torch/observability/telemetry.py"
KERNEL_REL = "antrea_tpu_torch/models/pipeline.py"
METRICS_REL = "antrea_tpu_torch/observability/metrics.py"

# Kernel emit sites: out-dict stores with a literal "tel_<name>" key, and
# (the port's form) tel_<name>= keyword arguments of a call.
TEL_KEY_RE = re.compile(r"\"tel_([a-z0-9_]+)\"")


def kernel_sites(text: str) -> set:
    """Counter names the kernel module emits: quoted "tel_<name>" keys,
    and tel_<name>= keywords of any call (dict(...), out.update(...))."""
    names = set(TEL_KEY_RE.findall(text))
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return names
    for node in ast.walk(tree):
        if (isinstance(node, ast.keyword) and node.arg
                and node.arg.startswith("tel_")):
            names.add(node.arg[len("tel_"):])
    return names


# The families the sentinel/regime plane registers beyond the per-counter
# totals.
EXTRA_FAMILIES = (
    "antrea_tpu_telemetry_regime_step_seconds",
    "antrea_tpu_telemetry_perf_regressions_total",
)


@analysis_pass("telemetry-registry",
               "kernel tel_* outputs == TelemetryPlane accumulators == "
               "metric families == README counter/regime rows")
def check(src: SourceCache) -> list[Finding]:
    def f(reason, obj, path=TELEMETRY_REL):
        return Finding("telemetry-registry", path, 0, reason, obj=obj)

    try:
        counters = _literal(src, src.pkg / "observability" / "telemetry.py",
                            "TELEMETRY_COUNTERS")
        regimes = _literal(src, src.pkg / "observability" / "telemetry.py",
                           "REGIMES")
        registry = _literal(src, src.pkg / "observability" / "metrics.py",
                            "METRICS")
    except (OSError, ValueError) as e:
        return [f(str(e), "literal-unreadable")]
    kernel_text = src.text(src.pkg / "models" / "pipeline.py")
    if kernel_text is None:
        return [f(f"{KERNEL_REL} is missing", "kernel-unreadable",
                  KERNEL_REL)]
    readme = src.text(src.root / "README.md") or ""

    problems: list[Finding] = []

    # Layer 1: kernel outputs <-> the accumulator literal.
    kernel = kernel_sites(kernel_text)
    for name in sorted(kernel - set(counters)):
        problems.append(f(
            f"kernel emits tel_{name} but TELEMETRY_COUNTERS does not "
            f"declare {name!r} — the plane would drop it on account()",
            f"undeclared:{name}", KERNEL_REL))
    for name in sorted(set(counters) - kernel):
        problems.append(f(
            f"TELEMETRY_COUNTERS declares {name!r} but no kernel site "
            f"emits tel_{name} — dead accumulator, renders 0 forever",
            f"unmeasured:{name}"))

    # Layer 2: one registered counter family per declared counter, and
    # the renderer's name->family map covers exactly the declared set
    # (a missing key raises at render time; a stale one renders a dead
    # family).
    try:
        families = _literal(src, src.pkg / "observability" / "metrics.py",
                            "_TELEMETRY_FAMILIES")
    except (OSError, ValueError) as e:
        return problems + [f(str(e), "families-unreadable", METRICS_REL)]
    for name in sorted(set(counters) - set(families)):
        problems.append(f(
            f"_TELEMETRY_FAMILIES has no entry for declared counter "
            f"{name!r} — render_metrics would KeyError on it",
            f"family-unmapped:{name}", METRICS_REL))
    for name in sorted(set(families) - set(counters)):
        problems.append(f(
            f"_TELEMETRY_FAMILIES maps {name!r} which TELEMETRY_COUNTERS "
            f"does not declare — dead map row",
            f"family-stale:{name}", METRICS_REL))
    for name, fam in sorted(families.items()):
        if fam not in registry:
            problems.append(f(
                f"{fam} is not registered in observability/metrics.METRICS",
                f"family-unregistered:{name}", METRICS_REL))
    for fam in EXTRA_FAMILIES:
        if fam not in registry:
            problems.append(f(
                f"{fam} is not registered in observability/metrics.METRICS",
                f"family-unregistered:{fam}", METRICS_REL))

    # Layer 3: operator documentation — a README row per counter, per
    # regime, and per family (the Hot-path telemetry section).
    for name in counters:
        if f"`{name}`" not in readme:
            problems.append(f(
                f"counter {name!r} has no README row (counter table in "
                f"the Hot-path telemetry section)",
                f"undocumented:{name}", "README.md"))
    for regime in regimes:
        if f"`{regime}`" not in readme:
            problems.append(f(
                f"regime {regime!r} has no README row (regime table in "
                f"the Hot-path telemetry section)",
                f"regime-undocumented:{regime}", "README.md"))
    for name, fam in sorted(families.items()):
        if fam not in readme:
            problems.append(f(f"{fam} has no README row",
                              f"family-undocumented:{name}", "README.md"))
    for fam in EXTRA_FAMILIES:
        if fam not in readme:
            problems.append(f(f"{fam} has no README row",
                              f"family-undocumented:{fam}", "README.md"))
    return problems
