"""Pass `bounded-cache` — executable-retaining caches must declare a
bound (the JAX package's pass of the same id, adapted to the port's
executables).

The bug class: a module-level `@lru_cache` whose entries hold an
EXECUTABLE — in the JAX package a jitted callable — retains one per
distinct key for the agent's whole lifetime; rule shapes churn across
bundle installs, so an unbounded cache is a slow leak that no test sees
and no metric names.  Every `functools.lru_cache` / `functools.cache`
decorated function whose body builds or holds an executable must declare
an explicit integer `maxsize` — `maxsize=None`, the bare forms and
`functools.cache` (which has no bound) are findings.

Adapted: the port's executables are its own.  A function is marked when
its body loads a built kernel library (`_build.load(...)`, a
`ctypes.CDLL(...)`), captures a CUDA graph (`torch.cuda.CUDAGraph`,
`torch.cuda.graph`) or compiles with `torch.compile`.

Functions that cache plain host data (numpy tables, parsed literals — the
port's one module-level cache, parallel/mesh._ring, holds a host ring) are
out of scope; eviction of an executable merely rebuilds it, so a bound is
always safe to add where this pass asks for one."""

from __future__ import annotations

import ast

from .core import Finding, SourceCache, analysis_pass, apply_allowlist

# (value, attribute) pairs whose presence in a decorated function's body
# marks it as building or holding an executable: a built kernel library
# (_build.load, ctypes.CDLL), a CUDA graph, a torch.compile program.
EXEC_MARKERS = {("_build", "load"), ("ctypes", "CDLL"), ("cuda", "CUDAGraph"),
                ("cuda", "graph"), ("torch", "compile")}
# Bare names that mark it the same way (`from ctypes import CDLL`, ...).
EXEC_NAMES = {"CDLL", "CUDAGraph"}

#: obj key ("relpath:function") -> reason.
CACHE_ALLOWLIST: dict[str, str] = {}


def _decorator_cache_call(dec: ast.AST):
    """-> ("lru_cache"|"cache", Call node or None) when `dec` is a
    functools cache decorator (bare or called), else None."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = (target.attr if isinstance(target, ast.Attribute)
            else target.id if isinstance(target, ast.Name) else None)
    if name in ("lru_cache", "cache"):
        return name, dec if isinstance(dec, ast.Call) else None
    return None


def _exec_marked(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            base = node.value
            base_name = (base.attr if isinstance(base, ast.Attribute)
                         else base.id if isinstance(base, ast.Name)
                         else None)
            if (base_name, node.attr) in EXEC_MARKERS:
                return True
        elif isinstance(node, ast.Name) and node.id in EXEC_NAMES:
            return True
    return False


def _explicit_maxsize(call: ast.Call | None) -> bool:
    """True when the decorator call declares maxsize=<int literal> (or a
    positional first arg that is an int literal)."""
    if call is None:
        return False
    for kw in call.keywords:
        if kw.arg == "maxsize":
            return (isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, int))
    if call.args:
        first = call.args[0]
        return (isinstance(first, ast.Constant)
                and isinstance(first.value, int))
    return False


@analysis_pass("bounded-cache", "caches retaining kernel libraries, CUDA "
                                "graphs or compiled programs declare an "
                                "explicit maxsize")
def check(src: SourceCache) -> list[Finding]:
    problems: list[Finding] = []
    for p in src.pkg_files():
        tree = src.tree(p)
        if tree is None:
            continue
        rel = src.rel(p)
        pkg_rel = str(p.relative_to(src.pkg)).replace("\\", "/")
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            for dec in node.decorator_list:
                hit = _decorator_cache_call(dec)
                if hit is None:
                    continue
                kind, call = hit
                if not _exec_marked(node):
                    continue  # host-data cache: out of scope
                if kind == "cache":
                    problems.append(Finding(
                        "bounded-cache", rel, node.lineno,
                        f"{node.name}() builds/holds an executable (kernel "
                        f"library, CUDA graph, compiled program) under "
                        f"@functools.cache, which has no bound — one is "
                        f"retained per key forever; use "
                        f"@lru_cache(maxsize=N)",
                        obj=f"{pkg_rel}:{node.name}"))
                elif not _explicit_maxsize(call):
                    problems.append(Finding(
                        "bounded-cache", rel, node.lineno,
                        f"{node.name}() builds/holds an executable (kernel "
                        f"library, CUDA graph, compiled program) but its "
                        f"lru_cache declares no integer maxsize (bare/None "
                        f"= unbounded) — shape churn retains one per key "
                        f"for the agent's lifetime; eviction only "
                        f"rebuilds, so bound it",
                        obj=f"{pkg_rel}:{node.name}"))
    return apply_allowlist("bounded-cache",
                           "antrea_tpu_torch/analysis/caches.py",
                           problems, CACHE_ALLOWLIST)
