"""Pass `thread-safety` — the apiserver handler-thread surface is
declared, and declared methods stay snapshot-only.

The agent API server (agent/apiserver.py) serves from a
ThreadingHTTPServer: every request handler runs on its OWN thread,
concurrently with the engine thread that steps traffic, swaps tenant
worlds and publishes epochs.  The bug class this pass pins is the one
review caught by hand twice — `tenant_stats()` originally entered
`_world_ctx` from the /metrics handler (interleaving with the engine's
own swap), and the flight recorder's `spans()`/`events()` needed
seq-window snapshot reads.  Machine-checked from now on:

  1. every datapath attribute the handler thread touches (directly in
     the apiserver routes, or through the /metrics renderers in
     observability/metrics.py, which take the datapath as a parameter
     and run on the handler thread) must be DECLARED in the
     `HANDLER_SAFE` literal of agent/apiserver.py — growing the
     operator surface means consciously adding to the contract;
  2. a declared name nobody touches is a stale declaration (finding);
  3. the BODY of every declared method (searched across the datapath/,
     parallel/ and observability/ subtrees) must not enter
     `_world_ctx(` (a world swap on a handler thread races the engine
     thread's swap) and must not assign `self.<attr>` (handler threads
     read snapshots; engine-state mutation belongs to the engine
     thread) — unless waived in THREAD_ALLOWLIST with a reason.

Scope note: the body check is ONE level deep on purpose — it gates the
declared surface's own discipline (the level where both hand-caught
bugs lived); transitive callees are engine code shared with the engine
thread and are the allowlisted tick endpoints' documented risk."""

from __future__ import annotations

import ast

from .core import Finding, SourceCache, analysis_pass, apply_allowlist

# Handler-thread entry points: Handler.do_GET -> outer._route -> these.
HANDLER_ENTRY_METHODS = ("_route", "_json_route", "_live_traceflow")

# Subtrees whose `def <name>(self` bodies implement the declared
# surface.  Controller/agent-side classes reuse method names like
# `stats` for unrelated surfaces and are not reachable through the
# datapath object the handlers hold.
IMPL_SUBTREES = ("datapath", "parallel", "observability")

# Modules whose MODULE-LEVEL functions receive the live datapath as a
# `datapath` parameter FROM a handler route and therefore run on the
# handler thread: the /metrics renderers and the /agentinfo collector.
# Their datapath reads count toward the HANDLER_SAFE contract exactly
# like the apiserver's own `self._dp` touches.
RENDER_MODULES = ("observability/metrics.py", "observability/agentinfo.py")

# obj key -> reason.  Keys are the finding objs below
# ("world-ctx:Class.method" / "mutates:Class.method:attr").  Empty at
# HEAD: every declared surface already serves from snapshots (the
# flight recorder's and tenant_stats' hardening) — future waivers must explain why a handler-thread
# write or swap is safe.
THREAD_ALLOWLIST: dict[str, str] = {}


def _attr_of_dp(node: ast.AST, dp_check) -> str | None:
    """`<dp>.attr` -> attr when the value matches dp_check."""
    if isinstance(node, ast.Attribute) and dp_check(node.value):
        return node.attr
    return None


def _collect_used(body: list[ast.stmt], dp_check) -> dict[str, int]:
    """Datapath attribute paths touched in a handler-thread body ->
    first line.  One level of local aliasing is followed
    (`tracer = self._dp.realization_tracer; tracer.spans(...)` counts
    as `realization_tracer.spans`)."""
    used: dict[str, int] = {}
    aliases: dict[str, str] = {}
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                attr = _attr_of_dp(node.value, dp_check)
                if attr is not None:
                    aliases[node.targets[0].id] = attr
            if isinstance(node, ast.Attribute):
                attr = _attr_of_dp(node, dp_check)
                if attr is not None:
                    used.setdefault(attr, node.lineno)
                elif (isinstance(node.value, ast.Name)
                      and node.value.id in aliases):
                    used.setdefault(
                        f"{aliases[node.value.id]}.{node.attr}", node.lineno)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr"
                    and len(node.args) >= 2
                    and dp_check(node.args[0])
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                used.setdefault(node.args[1].value, node.lineno)
    return used


def _handler_safe(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "HANDLER_SAFE"
                for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _is_self_dp(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "_dp"
            and isinstance(node.value, ast.Name) and node.value.id == "self")


def _iter_methods(tree: ast.AST):
    """(class name, FunctionDef) for every method in a module."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, ast.FunctionDef):
                    yield node.name, stmt


@analysis_pass("thread-safety", "apiserver handler threads touch only the "
                                "declared snapshot-safe surface")
def check(src: SourceCache) -> list[Finding]:
    api_rel = "antrea_tpu_torch/agent/apiserver.py"
    api_path = src.pkg / "agent" / "apiserver.py"
    tree = src.tree(api_path)
    if tree is None:
        return [Finding("thread-safety", api_rel, 0,
                        f"{api_rel} is missing/unparseable", obj="missing")]
    declared = _handler_safe(tree)
    if declared is None:
        return [Finding(
            "thread-safety", api_rel, 0,
            "agent/apiserver.py declares no HANDLER_SAFE literal — the "
            "handler-thread surface must be an explicit contract",
            obj="no-handler-safe")]
    declared = tuple(declared)

    problems: list[Finding] = []

    # 1. collect every datapath attr the handler thread touches.
    used: dict[str, tuple[str, int]] = {}
    for cls, meth in _iter_methods(tree):
        if meth.name not in HANDLER_ENTRY_METHODS:
            continue
        for attr, line in _collect_used(meth.body, _is_self_dp).items():
            used.setdefault(attr, (api_rel, line))
    # Handler-thread helpers handed the live object: the /metrics
    # renderers and the /agentinfo collector (the apiserver passes
    # self._dp bare into them, so their own `datapath.<attr>` reads ARE
    # handler-thread touches).
    def _is_dp_name(n: ast.AST) -> bool:
        return isinstance(n, ast.Name) and n.id == "datapath"

    for mod in RENDER_MODULES:
        mod_rel = f"antrea_tpu_torch/{mod}"
        mod_tree = src.tree(src.pkg / mod)
        if mod_tree is None:
            continue
        for node in ast.iter_child_nodes(mod_tree):
            if not (isinstance(node, ast.FunctionDef)
                    and "datapath" in [a.arg for a in node.args.args]):
                continue
            for attr, line in _collect_used(node.body, _is_dp_name).items():
                used.setdefault(attr, (mod_rel, line))

    for attr in sorted(set(used) - set(declared)):
        path, line = used[attr]
        problems.append(Finding(
            "thread-safety", path, line,
            f"handler thread touches datapath.{attr} but HANDLER_SAFE "
            f"(agent/apiserver.py) does not declare it — every handler-"
            f"reachable surface must be a conscious snapshot-safe "
            f"contract", obj=f"undeclared:{attr}"))
    for attr in sorted(set(declared) - set(used)):
        problems.append(Finding(
            "thread-safety", api_rel, 0,
            f"HANDLER_SAFE declares {attr!r} but no handler-thread path "
            f"touches it — stale declaration", obj=f"stale:{attr}"))

    # 3. body discipline of every declared method.
    wanted = {entry.split(".")[-1] for entry in declared}
    for p in src.pkg_files():
        parts = p.relative_to(src.pkg).parts
        if not parts or parts[0] not in IMPL_SUBTREES:
            continue
        mtree = src.tree(p)
        if mtree is None:
            continue
        rel = src.rel(p)
        for cls, meth in _iter_methods(mtree):
            if meth.name not in wanted:
                continue
            for node in ast.walk(meth):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "_world_ctx"):
                    problems.append(Finding(
                        "thread-safety", rel, node.lineno,
                        f"{cls}.{meth.name} enters _world_ctx() but is "
                        f"HANDLER_SAFE-declared — a world swap on the "
                        f"handler thread interleaves with the engine "
                        f"thread's own swap (the tenant_stats race class); "
                        f"read the stored world snapshots instead",
                        obj=f"world-ctx:{cls}.{meth.name}"))
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        problems.append(Finding(
                            "thread-safety", rel, node.lineno,
                            f"{cls}.{meth.name} assigns self.{t.attr} but "
                            f"is HANDLER_SAFE-declared — handler threads "
                            f"must read snapshots, never mutate engine "
                            f"state; move the write to the engine thread "
                            f"or waive with a reason",
                            obj=f"mutates:{cls}.{meth.name}:{t.attr}"))
    return apply_allowlist("thread-safety",
                           "antrea_tpu_torch/analysis/threads.py",
                           problems, THREAD_ALLOWLIST)
