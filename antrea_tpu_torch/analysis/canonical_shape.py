"""Pass `canonical-shape` — traffic-path dispatches take canonical batch
shapes.

The bug class (closed by the serving batcher): a dispatch site that feeds
a TRAFFIC-SHAPED lane subset straight into the step —
`self.step(_sub_batch(batch, sel), now)` — makes the per-call batch
dimension whatever traffic produced.  On the port the grids of the
hand-written kernels follow the batch shape, and so would any later CUDA
graph capture of the step (one graph per captured shape): a traffic-shaped
dispatch makes every distinct per-tenant lane count a new shape, where
the serving batcher's declared ladder holds the count of shapes to its
length.

The rule made structural: no `.step(...)` / `.tenant_step(...)` call
may receive a batch built by `_sub_batch(...)` — neither inline nor
through a local name assigned from it.  Re-shaping lane subsets for
dispatch belongs to the serving batcher (`serving/batcher.py`), which
pads onto the declared pow2 canonical ladder and masks the padding via
`valid`; staging a sub-batch into the batcher (`submit(_sub_batch(...))`)
is the sanctioned pattern and is not a dispatch, so it never matches.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceCache, analysis_pass, apply_allowlist

# The traffic-path dispatch surface.
DISPATCH_METHODS = {"step", "tenant_step"}

# The lane-subset constructor whose output is traffic-shaped.
SUBSET_BUILDERS = {"_sub_batch"}

#: obj key ("relpath:scope:method") -> reason.
SHAPE_ALLOWLIST: dict[str, str] = {}


def _call_name(node: ast.AST):
    """Callable's terminal name for Call nodes (Name or Attribute)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_subset_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _call_name(node.func) in SUBSET_BUILDERS)


def _scan_function(fn: ast.FunctionDef, rel: str, pkg_rel: str,
                   problems: list) -> None:
    # Local names holding a traffic-shaped subset: assigned (directly or
    # tuple-unpacked is out of scope — the builder returns one value)
    # from a SUBSET_BUILDERS call anywhere in this function body.
    tainted: set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and _is_subset_call(node.value)):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    tainted.add(tgt.id)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = _call_name(node.func)
        if (callee not in DISPATCH_METHODS
                or not isinstance(node.func, ast.Attribute)):
            continue
        for arg in node.args:
            traffic_shaped = (
                _is_subset_call(arg)
                or (isinstance(arg, ast.Name) and arg.id in tainted))
            if traffic_shaped:
                problems.append(Finding(
                    "canonical-shape", rel, node.lineno,
                    f"{fn.name}() dispatches a _sub_batch()-shaped batch "
                    f"through .{callee}() — the step's batch dimension "
                    f"then tracks traffic: kernel grids (and any graph "
                    f"capture) take one shape per distinct lane count "
                    f"(the pre-batcher step_tenants storm); stage the "
                    f"subset into the serving batcher "
                    f"(submit + flush packs it onto the canonical pow2 "
                    f"ladder, padding masked via valid) instead",
                    obj=f"{pkg_rel}:{fn.name}:{callee}"))
                break


@analysis_pass("canonical-shape", "traffic-path dispatches take "
                                  "pow2-padded or declared-canonical "
                                  "batch shapes")
def check(src: SourceCache) -> list[Finding]:
    problems: list[Finding] = []
    for p in src.pkg_files():
        tree = src.tree(p)
        if tree is None:
            continue
        rel = src.rel(p)
        pkg_rel = str(p.relative_to(src.pkg)).replace("\\", "/")
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _scan_function(node, rel, pkg_rel, problems)
    return apply_allowlist("canonical-shape",
                           "antrea_tpu_torch/analysis/canonical_shape.py",
                           problems, SHAPE_ALLOWLIST)
