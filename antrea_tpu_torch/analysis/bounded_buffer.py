"""Pass `bounded-buffer` — scanned-module buffers must declare their cap.

The bug class (the storm-soak round's structural lesson): the
dissemination plane sits between an unbounded producer (controller
churn) and slow consumers (10k agents on real sockets), so ANY
buffering structure in it — watcher queues, framing buffers, resync
cursors — is a fleet-wide memory liability unless something bounds it.
The watcher-overflow cap, the coalescing dict and the cursor snapshot
each earned an explicit bound; this pass makes the discipline
structural instead of reviewed-by-hand.  The replica-loss failover
plane (parallel/failover.py) joined the scan set: its probe-history
ring sits between an unbounded producer (every maintenance tick for the
engine's whole lifetime) and a consumer that may never read it
(supportbundle/debug), the same liability class.

  * every buffer-shaped instance attribute assigned in a scanned module
    (SCANNED_PREFIXES) — `self.<attr> = <container builder>`
    where <attr> smells like a buffer (queue/buf/pending/backlog/
    latest/cursor/inbox/ring/keys) and the value constructs a
    container (call, list/dict/set literal or comprehension, bytes
    literal) — must carry a row in that module's `BUFFER_CAPS` dict
    ("Class.attr" -> one-line reason naming the bound), or a reasoned
    allowlist entry here;
  * a stale `BUFFER_CAPS` row naming an attribute the module no longer
    assigns is itself a finding — declarations cannot outlive the
    buffers they excuse (the same discipline as the baseline file).
"""

from __future__ import annotations

import ast
import re

from .core import Finding, SourceCache, analysis_pass, apply_allowlist

# Attribute names that mark an instance attribute as a buffer.
BUFFER_RE = re.compile(
    r"queue|buf|pending|backlog|latest|cursor|inbox|ring|keys",
    re.IGNORECASE)

#: obj key ("relpath:Class.attr") -> reason.
BUFFER_ALLOWLIST: dict[str, str] = {}

# Modules the pass scans: whole packages (trailing "/") or single files.
# Growing this set is deliberate API — a new plane that buffers between
# an unbounded producer and a maybe-never consumer earns its entry here,
# and its module then owes BUFFER_CAPS rows.
SCANNED_PREFIXES = (
    "dissemination/",
    "parallel/failover.py",
)


def _is_container_builder(value: ast.AST) -> bool:
    """True when the assigned value constructs a growable container:
    any call (deque(), list(), bytearray(), factory...), a literal
    list/dict/set, a comprehension, or a bytes/str constant (framing
    accumulators start as b"")."""
    if isinstance(value, (ast.Call, ast.List, ast.Dict, ast.Set,
                          ast.ListComp, ast.DictComp, ast.SetComp,
                          ast.GeneratorExp)):
        return True
    return (isinstance(value, ast.Constant)
            and isinstance(value.value, (bytes, str)))


def _buffer_caps(tree: ast.AST) -> tuple[dict, int]:
    """-> (the module's BUFFER_CAPS literal, its line) — ({}, 0) when
    absent or not a pure literal."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "BUFFER_CAPS"
                        for t in node.targets)):
            try:
                val = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return {}, node.lineno
            return (val if isinstance(val, dict) else {}), node.lineno
    return {}, 0


def _class_buffers(cls: ast.ClassDef):
    """Yield (attr_name, lineno) for every buffer-shaped
    `self.<attr> = <builder>` in the class's methods."""
    for fn in ast.walk(cls):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for tgt in targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and BUFFER_RE.search(tgt.attr)
                        and _is_container_builder(value)):
                    yield tgt.attr, node.lineno


@analysis_pass("bounded-buffer", "dissemination buffering structures "
                                 "declare an explicit cap (BUFFER_CAPS)")
def check(src: SourceCache) -> list[Finding]:
    problems: list[Finding] = []
    for p in src.pkg_files():
        pkg_rel = str(p.relative_to(src.pkg)).replace("\\", "/")
        if not pkg_rel.startswith(SCANNED_PREFIXES):
            continue
        tree = src.tree(p)
        if tree is None:
            continue
        rel = src.rel(p)
        caps, caps_line = _buffer_caps(tree)
        seen: set[str] = set()
        for cls in (n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)):
            for attr, line in _class_buffers(cls):
                key = f"{cls.name}.{attr}"
                seen.add(key)
                reason = caps.get(key)
                if not (isinstance(reason, str) and reason.strip()):
                    problems.append(Finding(
                        "bounded-buffer", rel, line,
                        f"{key} builds a buffer with no declared cap — "
                        f"between an unbounded producer and a slow (or "
                        f"never-reading) consumer every scanned-module "
                        f"buffer needs an explicit bound; add a reasoned "
                        f"BUFFER_CAPS row naming what bounds it",
                        obj=f"{pkg_rel}:{key}"))
        for key in caps:
            if key not in seen:
                problems.append(Finding(
                    "bounded-buffer", rel, caps_line,
                    f"stale BUFFER_CAPS row {key!r}: the module no "
                    f"longer assigns that buffer — declarations must "
                    f"not outlive the buffers they excuse",
                    obj=f"{pkg_rel}:{key}:stale"))
    return apply_allowlist("bounded-buffer",
                           "antrea_tpu_torch/analysis/bounded_buffer.py",
                           problems, BUFFER_ALLOWLIST)
