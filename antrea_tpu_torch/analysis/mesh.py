"""Pass `mesh` — rule-placement drift: every field of the rule set is cut
by the rule split or declared replicated (the JAX package's pass of the
same id, adapted to the port's placement).

The JAX package places its pytrees on the (data x rule) mesh under
PartitionSpecs; the port has none.  Its rule shards are cut on the host by
FIELD NAME in parallel/mesh.rule_slice (the incidence and aggregate tables
on their trailing word axis, word_idx, the delta slots' rule masks), and
parallel/mesh.rule_join is the inverse (it concatenates the cut fields of
a row's shards and takes the rest from shard 0).  The same bug class as
the JAX pass's: a field added to one of the rule-set NamedTuples
(ops/match.py: DeviceRuleSet, DeviceDirection, DimTable, DeltaTable,
IsoTable) that rule_slice neither cuts nor anyone declared replicated
ships on every shard whole — and if it is rule-indexed, each shard then
reads words it does not own.  So:

  * every field of a tracked NamedTuple is either cut in rule_slice (a
    keyword of a `<Class>(...)` or `<value>._replace(...)` call, or a name
    of a `**{f: ... for f in ("a", "b")}` splat in one) or a row of the
    `MESH_REPLICATED` literal in parallel/mesh.py ("Class.field" -> why);
  * rule_join rejoins exactly the fields rule_slice cuts;
  * a MESH_REPLICATED row naming no tracked field, or a field that is cut,
    is stale; a row without a reason is a finding.

A `_replace` call is attributed to the one tracked class whose fields
include all its keywords; a call that fits none or several is itself a
finding (name the class, or split the call)."""

from __future__ import annotations

import ast

from .core import Finding, SourceCache, analysis_pass

# NamedTuples whose fields must be cut or declared, per defining module
# (package relative).
TRACKED = {
    "ops/match.py": (
        "DeviceRuleSet", "DeviceDirection", "DimTable", "IsoTable",
        "DeltaTable",
    ),
}

TRACKED_PATH = {cls: f"antrea_tpu_torch/{rel}"
                for rel, classes in TRACKED.items() for cls in classes}

SLICER = "rule_slice"
JOINER = "rule_join"
MESH_REL = "antrea_tpu_torch/parallel/mesh.py"


def namedtuple_fields(src: SourceCache, relpath: str, classes) -> dict:
    """class name -> ordered field names (AnnAssign rows of NamedTuple
    class bodies)."""
    tree = src.tree(src.pkg / relpath)
    out: dict[str, list[str]] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or node.name not in classes:
            continue
        out[node.name] = [
            stmt.target.id
            for stmt in node.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
        ]
    return out


def _call_keywords(call: ast.Call) -> set:
    """Keyword names of a call, a `**{f: ... for f in (<str literals>)}`
    splat's names included."""
    names = {kw.arg for kw in call.keywords if kw.arg}
    for kw in call.keywords:
        if kw.arg is None and isinstance(kw.value, ast.DictComp):
            for gen in kw.value.generators:
                try:
                    it = ast.literal_eval(gen.iter)
                except ValueError:
                    continue
                names |= {n for n in it if isinstance(n, str)}
    return names


def cut_fields(src: SourceCache, fn_name: str, fields: dict):
    """-> ({"Class.field" named at a constructor / _replace call inside
    parallel/mesh.<fn_name>}, [unattributable call lines]) or None when
    the function is missing."""
    tree = src.tree(src.pkg / "parallel" / "mesh.py")
    if tree is None:
        return None
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name == fn_name), None)
    if fn is None:
        return None
    cut: set[str] = set()
    loose: list[int] = []
    for call in ast.walk(fn):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        name = (f.attr if isinstance(f, ast.Attribute)
                else f.id if isinstance(f, ast.Name) else None)
        names = _call_keywords(call)
        if name in fields:
            cls = name
        elif name == "_replace" and names:
            fits = [c for c, fs in fields.items() if names <= set(fs)]
            if len(fits) != 1:
                loose.append(call.lineno)
                continue
            cls = fits[0]
        else:
            continue
        cut |= {f"{cls}.{n}" for n in names}
    return cut, loose


def replicated(src: SourceCache) -> dict:
    tree = src.tree(src.pkg / "parallel" / "mesh.py")
    if tree is None:
        raise ValueError(f"{MESH_REL} is missing/unparseable")
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            targets = [node.target.id]
        else:
            continue
        if "MESH_REPLICATED" in targets and node.value is not None:
            return ast.literal_eval(node.value)
    raise ValueError("parallel/mesh.py defines no MESH_REPLICATED literal")


@analysis_pass("mesh", "every rule-set field is cut by rule_slice (and "
                       "rejoined by rule_join) or declared replicated")
def check(src: SourceCache) -> list[Finding]:
    def f(reason, obj="", path=MESH_REL, line=0):
        return Finding("mesh", path, line, reason, obj=obj)

    try:
        declared = replicated(src)
    except (OSError, ValueError) as e:
        return [f(str(e), obj="no-replicated")]

    problems: list[Finding] = []
    fields: dict[str, list[str]] = {}
    for relpath, classes in TRACKED.items():
        got = namedtuple_fields(src, relpath, classes)
        for cls in classes:
            if cls not in got:
                problems.append(f(
                    f"antrea_tpu_torch/{relpath} no longer defines {cls} — "
                    f"update the analysis mesh pass's TRACKED table",
                    obj=f"missing-class:{cls}",
                    path=f"antrea_tpu_torch/{relpath}"))
            else:
                fields[cls] = got[cls]
    qualified = {f"{c}.{n}" for c, fs in fields.items() for n in fs}

    sliced = cut_fields(src, SLICER, fields)
    joined = cut_fields(src, JOINER, fields)
    for name, got in ((SLICER, sliced), (JOINER, joined)):
        if got is None:
            problems.append(f(f"parallel/mesh.py defines no {name}()",
                              obj=f"no-{name}"))
            continue
        for line in got[1]:
            problems.append(f(
                f"{name}() calls _replace with keywords that fit no single "
                f"tracked NamedTuple — construct the class by name or "
                f"split the call", obj=f"unattributed:{name}", line=line))
    if sliced is None or joined is None:
        return problems
    cut, rejoined = sliced[0], joined[0]

    for key in sorted(qualified - cut - set(declared)):
        cls = key.partition(".")[0]
        problems.append(f(
            f"{key} ({TRACKED_PATH[cls]}) is neither cut in {SLICER}() nor "
            f"declared in MESH_REPLICATED — it would ship whole on every "
            f"rule shard by accident", obj=key))
    for key in sorted(cut - rejoined):
        problems.append(f(
            f"{key} is cut by {SLICER}() but {JOINER}() does not rejoin "
            f"it — the joined rule set would keep shard 0's slice",
            obj=f"unjoined:{key}"))
    for key in sorted(rejoined - cut):
        problems.append(f(
            f"{key} is concatenated by {JOINER}() but {SLICER}() does not "
            f"cut it — the join would repeat a whole field n_rule times",
            obj=f"uncut-join:{key}"))
    for key in sorted(cut - qualified):
        problems.append(f(
            f"{SLICER}() names {key}, which is no field of a tracked "
            f"NamedTuple", obj=f"unknown-cut:{key}"))

    for key, reason in declared.items():
        if key not in qualified:
            problems.append(f(
                f"MESH_REPLICATED declares {key!r} (expected 'Class.field' "
                f"of a tracked NamedTuple) — stale row",
                obj=f"stale-replicated:{key}"))
        elif key in cut:
            problems.append(f(
                f"MESH_REPLICATED declares {key!r}, but {SLICER}() cuts "
                f"it — drop the stale row", obj=f"cut-replicated:{key}"))
        if not (isinstance(reason, str) and reason.strip()):
            problems.append(f(
                f"MESH_REPLICATED row {key!r} carries no reason",
                obj=f"reasonless-replicated:{key}"))
    return problems

