"""Pass `metrics` — metric-name drift: registry == emissions == README
(the JAX package's pass of the same id, adapted to the port's name).

Three-way consistency over the `antrea_tpu_*` metric namespace (the port
keeps the JAX metric names, so README's inventory serves both packages):

  1. every name in the METRICS registry
     (antrea_tpu_torch/observability/metrics.py) appears in README.md's
     "Observability" metric inventory, and vice versa — the README table
     is the operator contract;
  2. every `antrea_tpu_*` literal anywhere under antrea_tpu_torch/
     resolves to a registered family (histogram `_bucket`/`_sum`/`_count`
     suffixes fold to their family), so nothing can be emitted
     unregistered.

Adapted: the namespace pattern does not count the package's own name
(`antrea_tpu_torch`, and module paths such as
`antrea_tpu_torch.dissemination.agent_proc`) as a metric; the JAX pattern
reads it as the unregistered family `antrea_tpu_torch`.

metrics.py is loaded directly from its path (it depends only on the
stdlib by design), never via the package import — no torch, ever."""

from __future__ import annotations

import importlib.util
import re

from .core import Finding, SourceCache, analysis_pass

# A metric name in the namespace; the package name itself (a whole word:
# antrea_tpu_torch followed by anything but a name character) is not one.
NAME_RE = re.compile(r"antrea_tpu_(?!torch(?![a-z0-9_]))[a-z0-9_]+")
_SUFFIXES = ("_bucket", "_sum", "_count")


def load_registry(src: SourceCache) -> dict:
    path = src.pkg / "observability" / "metrics.py"
    spec = importlib.util.spec_from_file_location("_metrics_standalone", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod.METRICS)


def _family(name: str, registry: dict) -> str:
    """Fold histogram sample suffixes onto their family name."""
    if name in registry:
        return name
    for suf in _SUFFIXES:
        if name.endswith(suf) and name[: -len(suf)] in registry:
            return name[: -len(suf)]
    return name


def readme_names(src: SourceCache, registry: dict) -> set:
    text = src.text(src.root / "README.md") or ""
    return {_family(n, registry) for n in NAME_RE.findall(text)}


def source_names(src: SourceCache, registry: dict) -> set:
    """Every antrea_tpu_* literal under antrea_tpu_torch/ (emissions + the
    comments that cite them — citing an unregistered name is drift too).
    The analysis plane itself is excluded (core.SourceCache.pkg_files):
    passes quote name prefixes they classify by."""
    out = set()
    for p in src.pkg_files():
        for n in NAME_RE.findall(src.text(p) or ""):
            out.add(_family(n, registry))
    return out


@analysis_pass("metrics", "metric registry == README table == source "
                          "emissions")
def check(src: SourceCache) -> list[Finding]:
    reg_rel = "antrea_tpu_torch/observability/metrics.py"
    try:
        registry = load_registry(src)
    except Exception as e:  # noqa: BLE001 — any load failure is the finding
        return [Finding("metrics", reg_rel, 0,
                        f"cannot load METRICS registry: {e}",
                        obj="registry-unloadable")]
    reg = set(registry)
    readme = readme_names(src, registry)
    source = source_names(src, registry)
    problems = []
    for n in sorted(reg - readme):
        problems.append(Finding(
            "metrics", "README.md", 0,
            f"registered but missing from README.md: {n}", obj=f"readme:{n}"))
    for n in sorted(readme - reg):
        problems.append(Finding(
            "metrics", "README.md", 0,
            f"in README.md but not registered: {n}", obj=f"unreg-readme:{n}"))
    for n in sorted(source - reg):
        problems.append(Finding(
            "metrics", reg_rel, 0,
            f"referenced in source but not registered: {n}",
            obj=f"unreg-src:{n}"))
    # The registry itself lives in source, so reg - source only flags names
    # nobody renders NOR documents in code — dead registry entries.
    return problems
