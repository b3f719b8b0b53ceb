"""Core of the port's static-analysis plane.

One engine for every compile-time gate over antrea_tpu_torch/: the drift
checks the JAX package runs over its own tree (carried over, or adapted
where their anchor is JAX-only) and the semantic passes that pin bug
classes review kept catching by hand (handler-thread reads of live engine
state, unbounded executable-retaining caches, undeclared device->host
syncs on the step's device code).

Design (the JAX package's analysis/core.py, over the port):

  * DEPENDENCY-FREE: stdlib `ast`/`re`/`json` only, no torch, no jax and
    nothing of the JAX package; every pass runs on any CI image, and the
    whole suite runs from tests/test_torch_analysis.py in ONE invocation.
  * ONE PARSED-MODULE CACHE: `SourceCache` parses each file at most once
    per run, shared by all passes.
  * TYPED FINDINGS: every problem is a `Finding` with file:line, the pass
    id, a stable key and a human reason; machine-readable via
    `python -m antrea_tpu_torch.analysis --json`.
  * REASONED ALLOWLISTS: a pass-level allowlist entry must carry a
    non-empty reason string; a stale entry (waiving something that no
    longer exists or no longer fires) is itself a finding.
  * BASELINE: `BASELINE.analysis_torch.json` at the repo root suppresses
    known findings BY KEY with a reason; a baseline row that matches no
    live finding is stale and fails the build, so suppressions can never
    outlive the code they excuse.

Scanning scope note: package-wide scans (`SourceCache.pkg_files`) exclude
`antrea_tpu_torch/analysis/` itself (the passes quote the very patterns
they police: emit kinds, forbidden call sites, metric-name prefixes, sync
calls), and `_build/` and `csrc/` (build outputs and CUDA sources).
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

# Repo root when scanning ourselves (the CLI and the tests default to
# it); every entry point also accepts an explicit root so the parity
# and seeded-violation tests can run the same passes over synthetic
# trees.
REPO = pathlib.Path(__file__).resolve().parent.parent.parent

BASELINE_NAME = "BASELINE.analysis_torch.json"

# The package the passes scan, and its subtrees that package scans skip.
PKG = "antrea_tpu_torch"
UNSCANNED = ("analysis", "_build", "csrc")


@dataclass(frozen=True)
class Finding:
    """One problem a pass proved about the tree.

    `obj` is the stable identity of the finding (a symbol like
    "FlowCache.ts" or "TpuflowDatapath._drain_classify") — the baseline
    keys on (pass, path, obj) so line churn never invalidates a
    suppression.  Legacy-ported passes that predate symbol identities
    fall back to the reason text, which is equally stable under the
    no-drift assumption those gates exist to enforce."""

    pass_id: str
    path: str  # repo-relative, "/"-separated
    line: int
    reason: str
    obj: str = ""

    @property
    def key(self) -> str:
        return f"{self.pass_id}:{self.path}:{self.obj or self.reason}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"DRIFT[{self.pass_id}] {loc}: {self.reason}"


class SourceCache:
    """The one parsed-module cache of a run: text + AST per file, and
    the package file walk, each computed at most once."""

    def __init__(self, root: pathlib.Path | str = REPO):
        self.root = pathlib.Path(root)
        self.pkg = self.root / PKG
        self._text: dict[pathlib.Path, Optional[str]] = {}
        self._tree: dict[pathlib.Path, Optional[ast.AST]] = {}
        self._pkg_files: Optional[list[pathlib.Path]] = None

    def rel(self, path: pathlib.Path) -> str:
        return str(path.relative_to(self.root)).replace("\\", "/")

    def text(self, path: pathlib.Path) -> Optional[str]:
        """File contents, or None when missing (callers decide whether
        a missing file is itself a finding)."""
        path = pathlib.Path(path)
        if path not in self._text:
            try:
                self._text[path] = path.read_text()
            except OSError:
                self._text[path] = None
        return self._text[path]

    def tree(self, path: pathlib.Path) -> Optional[ast.AST]:
        path = pathlib.Path(path)
        if path not in self._tree:
            text = self.text(path)
            try:
                self._tree[path] = None if text is None else ast.parse(text)
            except SyntaxError:
                self._tree[path] = None
        return self._tree[path]

    def pkg_files(self) -> list[pathlib.Path]:
        """Every antrea_tpu_torch/**/*.py EXCEPT the analysis plane itself
        (whose sources quote the patterns the passes police) and the build
        and CUDA source directories."""
        if self._pkg_files is None:
            self._pkg_files = sorted(
                p for p in self.pkg.rglob("*.py")
                if p.relative_to(self.pkg).parts[0] not in UNSCANNED
            )
        return self._pkg_files


# --------------------------------------------------------------------------
# Pass registry.
# --------------------------------------------------------------------------

#: pass id -> (callable(SourceCache) -> list[Finding], one-line invariant)
PASSES: dict[str, tuple[Callable[[SourceCache], list[Finding]], str]] = {}


def analysis_pass(pass_id: str, invariant: str):
    """Register `fn(src) -> list[Finding]` as a pass of the suite."""

    def deco(fn):
        if pass_id in PASSES:
            raise ValueError(f"duplicate analysis pass id {pass_id!r}")
        PASSES[pass_id] = (fn, invariant)
        fn.pass_id = pass_id
        return fn

    return deco


def pat_slug(pattern: str) -> str:
    """A regex/pattern literal reduced to a stable identifier for
    finding keys (escapes and parens stripped, dots trimmed) — keys
    must survive line churn, so passes key rogue-call-site findings on
    the PATTERN, never the line number."""
    return re.sub(r"[\\()]", "", pattern).strip(".")


def apply_allowlist(pass_id: str, path: str, findings: list[Finding],
                    allowlist: dict[str, str]) -> list[Finding]:
    """Shared allowlist discipline: drop findings whose `obj` is waived,
    require a reason on every entry, and flag stale entries (waiving an
    obj no pass run produced) — `path` attributes the allowlist table
    itself for those meta-findings."""
    seen_objs = {f.obj for f in findings}
    out = [f for f in findings if f.obj not in allowlist]
    for obj, reason in allowlist.items():
        if not (isinstance(reason, str) and reason.strip()):
            out.append(Finding(pass_id, path, 0,
                               f"allowlist entry {obj!r} carries no reason",
                               obj=f"allowlist:{obj}"))
        elif obj not in seen_objs:
            out.append(Finding(pass_id, path, 0,
                               f"allowlist entry {obj!r} waives nothing the "
                               f"pass still finds — stale waiver, drop it",
                               obj=f"allowlist-stale:{obj}"))
    return out


# --------------------------------------------------------------------------
# Baseline suppression.
# --------------------------------------------------------------------------

@dataclass
class RunResult:
    findings: list[Finding] = field(default_factory=list)  # unsuppressed
    suppressed: list[Finding] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)  # baseline problems
    pass_ids: list[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors

    def to_json(self) -> dict:
        def row(f: Finding, suppressed: bool) -> dict:
            return {"pass": f.pass_id, "path": f.path, "line": f.line,
                    "obj": f.obj, "reason": f.reason, "key": f.key,
                    "suppressed": suppressed}

        return {
            "passes": self.pass_ids,
            "clean": self.clean,
            "findings": ([row(f, False) for f in self.findings]
                         + [row(f, True) for f in self.suppressed]),
            "errors": self.errors,
        }


def load_baseline(root: pathlib.Path) -> tuple[dict[str, str], list[str]]:
    """-> ({finding key: reason}, structural problems).  A missing file
    is an empty baseline; a malformed one fails the build."""
    path = pathlib.Path(root) / BASELINE_NAME
    if not path.exists():
        return {}, []
    try:
        raw = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return {}, [f"{BASELINE_NAME}: unreadable ({e})"]
    rows = raw.get("findings", raw) if isinstance(raw, dict) else None
    if not isinstance(rows, dict):
        return {}, [f"{BASELINE_NAME}: expected a JSON object mapping "
                    f"finding keys to suppression reasons"]
    problems = [
        f"{BASELINE_NAME}: entry {k!r} carries no reason"
        for k, v in rows.items()
        if not (isinstance(v, str) and v.strip())
    ]
    return dict(rows), problems


def run(root: pathlib.Path | str = REPO,
        pass_ids: Optional[Iterable[str]] = None) -> RunResult:
    """Run the selected passes (default: all, in registration order)
    over `root`, apply the baseline, and return the typed result.

    Baseline semantics: every selected pass's findings are suppressed
    by key; a baseline row whose pass was selected but whose key no
    finding produced is STALE and fails the run (rows belonging to
    unselected passes are left alone, so `--pass` stays usable)."""
    import antrea_tpu_torch.analysis  # noqa: F401 — ensure all passes registered

    src = SourceCache(root)
    ids = list(pass_ids) if pass_ids is not None else list(PASSES)
    unknown = [i for i in ids if i not in PASSES]
    if unknown:
        raise KeyError(
            f"unknown analysis pass(es) {unknown} — registered: "
            f"{', '.join(PASSES)}")
    baseline, errors = load_baseline(src.root)
    result = RunResult(errors=list(errors), pass_ids=ids)
    matched: set[str] = set()
    for pid in ids:
        fn, _invariant = PASSES[pid]
        for f in fn(src):
            if f.key in baseline:
                matched.add(f.key)
                result.suppressed.append(f)
            else:
                result.findings.append(f)
    selected = set(ids)
    for key, _reason in baseline.items():
        kpass = key.split(":", 1)[0]
        if kpass in selected and key not in matched:
            result.errors.append(
                f"{BASELINE_NAME}: stale entry {key!r} — pass {kpass!r} no "
                f"longer produces this finding; drop the row")
        elif kpass not in PASSES:
            result.errors.append(
                f"{BASELINE_NAME}: entry {key!r} names unknown pass "
                f"{kpass!r}")
    return result


def run_cli(pass_id: str, argv: Optional[list[str]] = None) -> int:
    """Run ONE pass (baseline applied, exactly like the full suite), print
    its findings in the DRIFT format, exit 0/1.  Accepts an optional
    `--root PATH` (the seeded-violation harness)."""
    argv = list(argv or [])
    root = REPO
    if "--root" in argv:
        i = argv.index("--root")
        try:
            root = pathlib.Path(argv[i + 1])
        except IndexError:
            print(f"usage: run_cli({pass_id!r}, [--root PATH])")
            return 2
    result = run(root, [pass_id])
    for f in result.findings:
        print(f.render())
    for e in result.errors:
        print(f"DRIFT[{pass_id}] {e}")
    if not result.clean:
        return 1
    _fn, invariant = PASSES[pass_id]
    extra = (f", {len(result.suppressed)} baselined"
             if result.suppressed else "")
    print(f"analysis pass {pass_id!r} clean: {invariant}{extra}")
    return 0
