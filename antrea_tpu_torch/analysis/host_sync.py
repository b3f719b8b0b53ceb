"""Pass `host-sync` — every device->host sync in the step's device code is
declared (the port's meaning of the JAX package's `jit-purity` pass).

The JAX bug class is a host coercion inside a jitted body: it forces a
device->host sync on every call, and no parity test sees it because the
verdicts stay right; only the latency is wrong.  The port's step is eager,
so its device code is the Python of models/ and ops/ (the counterparts of
the JAX package's jitted bodies), and every sync there blocks the host
until the card has drained the queue ahead of it: the card idles while
the host issues the next launches, and a CUDA graph cannot capture a step
across it.  The syncs are allowed, but each is a conscious decision:

  * every explicit sync call in a function of the scanned modules —
    `.item()`, `.tolist()`, `.cpu()`, `.numpy()`; a data-sized result
    (`torch.nonzero` / `.nonzero()`, `torch.argwhere`, `torch.unique` /
    `.unique()`, `unique_consecutive`, `masked_select`); any
    `.synchronize()` (`torch.cuda.synchronize`, a stream's, an event's);
    `.to("cpu")` / `.to(torch.device("cpu"))` / `.to(device="cpu")` — must
    be declared in that module's `HOST_SYNCS` literal.  A key is
    "function" or "Class.method" (a nested function is keyed by its own
    name, as its frame's qualified name ends), its value a one-line
    reason.  numpy's own module functions (`np.nonzero`, `np.unique`) are
    host code and do not match; a match on a numpy value is declared with
    a reason that starts with "host:";
  * syncs no untyped AST can see — `bool(t)`, `if t`, `int(t)` /
    `float(t)` of a tensor, a comparison of a tensor used as a Python
    bool, a boolean-mask index, an upload from host memory — are declared
    in the same literal with a reason that starts with "implicit:";
  * a row whose function is gone is stale, and so is a row not marked
    "implicit:" whose function no longer holds an explicit sync.

The card holds the declaration: chip_smoke.py's phase 21 steps the
headline engine and the bare staged step under
`torch.cuda.set_sync_debug_mode("warn")`, attributes every sync to the
innermost frame inside antrea_tpu_torch/ (`utils/sync_census.py`, keyed by
`site_key`), and fails on a sync in models/ or ops/ at a function no
HOST_SYNCS row declares."""

from __future__ import annotations

import ast
import pathlib

from .core import Finding, SourceCache, analysis_pass, PKG

# Package-relative prefixes of the modules the pass scans.
SCOPE = ("models/", "ops/")

# `.name()` calls that copy a device value to the host.
TO_HOST = {"item", "tolist", "cpu", "numpy"}
# Calls whose output size depends on the data (the host reads the size).
DATA_SIZED = {"nonzero", "argwhere", "unique", "unique_consecutive",
              "masked_select"}
# Receivers whose attribute calls are numpy's own host functions.
HOST_MODULES = {"np", "numpy"}

IMPLICIT = "implicit:"


def site_key(qualname: str) -> str:
    """A function's HOST_SYNCS key from its qualified name (a frame's
    co_qualname): "Class.method" for a method, the function's own name
    for a function, nested ones included ("f.<locals>.g" -> "g")."""
    return qualname.rpartition("<locals>.")[2]


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "device" and len(node.args) == 1
            and _is_cpu(node.args[0]))


def sync_call(call: ast.Call) -> str | None:
    """The sync an explicit call performs ("tolist", "nonzero", ...), or
    None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    name = fn.attr
    if name in TO_HOST or name == "synchronize":
        return name
    if name in DATA_SIZED:
        if isinstance(fn.value, ast.Name) and fn.value.id in HOST_MODULES:
            return None
        return name
    if name == "to":
        dev = call.args[0] if call.args else next(
            (k.value for k in call.keywords if k.arg == "device"), None)
        if dev is not None and _is_cpu(dev):
            return "to-cpu"
    return None


def functions(tree: ast.AST):
    """(key, FunctionDef) for every function of a module."""
    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield (f"{cls}.{child.name}" if cls else child.name), child
                yield from visit(child, None)
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, child.name)
            else:
                yield from visit(child, None)

    yield from visit(tree, None)


def explicit_syncs(fn: ast.AST):
    """(call line, sync name) of the explicit syncs in a function's own
    body (nested functions are their own sites)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            kind = sync_call(node)
            if kind is not None:
                yield node.lineno, kind
        stack.extend(ast.iter_child_nodes(node))


def host_syncs(tree: ast.AST) -> tuple[dict, int]:
    """-> (the module's HOST_SYNCS literal, its line); ({}, 0) when the
    module declares none."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "HOST_SYNCS"
                        for t in node.targets)):
            try:
                val = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return {}, node.lineno
            return (val if isinstance(val, dict) else {}), node.lineno
    return {}, 0


def scanned(src: SourceCache):
    """(path, package-relative path) of every module in SCOPE."""
    for p in src.pkg_files():
        pkg_rel = str(p.relative_to(src.pkg)).replace("\\", "/")
        if pkg_rel.startswith(SCOPE):
            yield p, pkg_rel


def declared(root: pathlib.Path | str) -> dict:
    """{package-relative path: HOST_SYNCS} of every scanned module of the
    tree at `root` (an empty dict where a module declares none): what the
    census holds the card's syncs to."""
    src = SourceCache(root)
    out = {}
    for p, pkg_rel in scanned(src):
        tree = src.tree(p)
        if tree is not None:
            out[pkg_rel] = host_syncs(tree)[0]
    return out


@analysis_pass("host-sync", "every device->host sync in models/ and ops/ "
                            "is declared in its module's HOST_SYNCS")
def check(src: SourceCache) -> list[Finding]:
    problems: list[Finding] = []
    for p, pkg_rel in scanned(src):
        tree = src.tree(p)
        if tree is None:
            continue
        rel = src.rel(p)
        table, table_line = host_syncs(tree)
        keys, with_sync = set(), set()
        for key, fn in functions(tree):
            keys.add(key)
            for line, kind in explicit_syncs(fn):
                with_sync.add(key)
                reason = table.get(key)
                if not (isinstance(reason, str) and reason.strip()):
                    problems.append(Finding(
                        "host-sync", rel, line,
                        f"{key}() syncs the host with the card ({kind}) but "
                        f"{PKG}/{pkg_rel} declares no HOST_SYNCS row for it "
                        f"— the host blocks until the queue drains, and no "
                        f"graph capture can cross it; declare it with a "
                        f"reason, or keep the value on the card",
                        obj=f"{pkg_rel}:{key}:{kind}"))
        for key, reason in table.items():
            if not (isinstance(reason, str) and reason.strip()):
                problems.append(Finding(
                    "host-sync", rel, table_line,
                    f"HOST_SYNCS row {key!r} carries no reason",
                    obj=f"{pkg_rel}:{key}:reasonless"))
            elif key not in keys:
                problems.append(Finding(
                    "host-sync", rel, table_line,
                    f"stale HOST_SYNCS row {key!r}: the module defines no "
                    f"such function", obj=f"{pkg_rel}:{key}:stale"))
            elif key not in with_sync and not reason.startswith(IMPLICIT):
                problems.append(Finding(
                    "host-sync", rel, table_line,
                    f"stale HOST_SYNCS row {key!r}: {key}() holds no "
                    f"explicit sync any more (a sync no AST sees is "
                    f"declared with a reason starting {IMPLICIT!r})",
                    obj=f"{pkg_rel}:{key}:stale"))
    return problems
