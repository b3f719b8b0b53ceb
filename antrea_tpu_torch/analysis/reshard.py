"""Pass `reshard` — every per-replica state field migrates (the JAX
package's pass of the same id, adapted to the port's placement).

The elastic resharding plane (parallel/reshard.py) moves the stateful
tables to their new home replicas when the data axis resizes.  A NEW
stateful field that nobody taught the migrator is a silent flow-loss bug.

Adapted: the JAX pass derives the stateful fields from the `P(DATA, ...)`
specs of `_state_specs`; the port has no specs.  Its whole PipelineState
is per replica (parallel/mesh.shard_state cuts data shard d's private flow
cache and affinity table; the mesh engine keeps each replica's state), so
every field of `FlowCache` and `AffinityTable` (models/pipeline.py) must
carry a rule in `reshard.RESHARD_MANIFEST` ("Class.field" -> rule text),
and every manifest row must name such a field.

Tenant worlds carry their OWN per-replica state: a member of the mesh
engine's `_TENANT_WORLD_FIELDS` (parallel/meshpath.py, which extends the
single-card engine's tuple in datapath/tpuflow.py) that is assigned from a
state builder — `_init_pipeline_state` (the mesh engine's override builds
every replica's state), `shard_state`, or the reshard plane's
`_place_state` — anywhere in the mesh engine, its base engine or the
reshard plane, is a per-world device table a resize must walk, so each
such member must carry a rule in `reshard.WORLD_MIGRATION`."""

from __future__ import annotations

import ast

from .core import Finding, SourceCache, analysis_pass

# The per-replica state NamedTuples (models/pipeline.py).
STATE_CLASSES = ("FlowCache", "AffinityTable")

# Call targets whose result is per-replica device state: a world field
# assigned from one of these holds per-replica rows a resize must migrate
# (the detection is assignment-shaped, not name-shaped, so a new world
# field cannot dodge the pass by picking a fresh name).
SHARDED_BUILDERS = {"_init_pipeline_state", "shard_state", "_place_state"}

# Modules whose assignments place the mesh engine's world state: the mesh
# engine, the single-card engine it extends, and the reshard plane.
PLACING_MODULES = ("parallel/meshpath.py", "datapath/tpuflow.py",
                   "parallel/reshard.py")


def state_fields(src: SourceCache) -> set:
    """'Class.field' for every field of the per-replica state classes."""
    tree = src.tree(src.pkg / "models" / "pipeline.py")
    out: set[str] = set()
    if tree is None:
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in STATE_CLASSES:
            out |= {f"{node.name}.{stmt.target.id}" for stmt in node.body
                    if isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)}
    return out


def _module_literal(src: SourceCache, path, name: str):
    tree = src.tree(path)
    if tree is None:
        raise ValueError(f"{src.rel(path)} is missing")
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            targets = [node.target.id]
        else:
            continue
        if name in targets and node.value is not None:
            return ast.literal_eval(node.value)
    raise ValueError(f"{src.rel(path)} defines no {name} literal")


def manifest(src: SourceCache) -> dict:
    return _module_literal(src, src.pkg / "parallel" / "reshard.py",
                           "RESHARD_MANIFEST")


def world_migration(src: SourceCache) -> dict:
    return _module_literal(src, src.pkg / "parallel" / "reshard.py",
                           "WORLD_MIGRATION")


def _class_attr_tuple(tree: ast.AST, cls: str, name: str):
    """The value node of `name = ...` in class `cls`'s body, or None."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == name
                                for t in stmt.targets)):
                    return stmt.value
    return None


def world_fields(src: SourceCache) -> set:
    """The mesh engine's _TENANT_WORLD_FIELDS: its own literal tail plus
    the single-card engine's tuple it extends
    (`TpuflowDatapath._TENANT_WORLD_FIELDS + (...)`)."""
    mtree = src.tree(src.pkg / "parallel" / "meshpath.py")
    if mtree is None:
        raise ValueError("antrea_tpu_torch/parallel/meshpath.py is missing")
    value = _class_attr_tuple(mtree, "MeshDatapath", "_TENANT_WORLD_FIELDS")
    if value is None:
        raise ValueError("MeshDatapath defines no _TENANT_WORLD_FIELDS")
    parts = ([value.left, value.right] if isinstance(value, ast.BinOp)
             else [value])
    out: set[str] = set()
    for part in parts:
        if (isinstance(part, ast.Attribute)
                and part.attr == "_TENANT_WORLD_FIELDS"
                and isinstance(part.value, ast.Name)):
            ttree = src.tree(src.pkg / "datapath" / "tpuflow.py")
            base = (None if ttree is None else
                    _class_attr_tuple(ttree, part.value.id,
                                      "_TENANT_WORLD_FIELDS"))
            if base is None:
                raise ValueError(f"{part.value.id}._TENANT_WORLD_FIELDS is "
                                 f"not a literal of datapath/tpuflow.py")
            out |= set(ast.literal_eval(base))
        else:
            out |= set(ast.literal_eval(part))
    return out


def sharded_world_fields(src: SourceCache) -> set:
    """World fields assigned from a state builder in PLACING_MODULES: an
    attribute target (`self._state = ...`, `o._state = ...`) or a string
    subscript target (`f["_state"] = ...`)."""
    fields = world_fields(src)
    assigned: set[str] = set()
    for rel in PLACING_MODULES:
        tree = src.tree(src.pkg / rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            fn = node.value.func
            callee = (fn.attr if isinstance(fn, ast.Attribute)
                      else fn.id if isinstance(fn, ast.Name) else None)
            if callee not in SHARDED_BUILDERS:
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    assigned.add(t.attr)
                elif (isinstance(t, ast.Subscript)
                      and isinstance(t.slice, ast.Constant)
                      and isinstance(t.slice.value, str)):
                    assigned.add(t.slice.value)
    return assigned & fields


@analysis_pass("reshard", "every per-replica state field has a reshard "
                          "migration rule")
def check(src: SourceCache) -> list[Finding]:
    reshard_rel = "antrea_tpu_torch/parallel/reshard.py"
    pipeline_rel = "antrea_tpu_torch/models/pipeline.py"

    def f(reason, obj, path=reshard_rel):
        return Finding("reshard", path, 0, reason, obj=obj)

    try:
        rules = manifest(src)
    except (OSError, ValueError) as e:
        return [f(str(e), "no-manifest")]
    sharded = state_fields(src)
    if not sharded:
        return [f(f"models/pipeline.py defines no {STATE_CLASSES} fields — "
                  f"the parse is broken or the state moved",
                  "no-sharded-fields", pipeline_rel)]

    problems: list[Finding] = []
    for key in sorted(sharded - set(rules)):
        problems.append(f(
            f"{key} is per-replica state (models/pipeline.py) but has NO "
            f"migration rule in reshard.RESHARD_MANIFEST — a live resize "
            f"would silently zero it (flow loss); teach the migrator and "
            f"document the rule", f"unmigrated:{key}"))
    for key in sorted(set(rules) - sharded):
        problems.append(f(
            f"RESHARD_MANIFEST names {key!r}, which is not a field of "
            f"{' / '.join(STATE_CLASSES)} — stale manifest row",
            f"stale:{key}"))
    for key, rule in rules.items():
        if not (isinstance(rule, str) and rule.strip()):
            problems.append(f(
                f"RESHARD_MANIFEST[{key!r}] carries no rule text",
                f"no-rule:{key}"))

    # Tenant worlds: every _TENANT_WORLD_FIELDS member assigned from a
    # state builder must carry a WORLD_MIGRATION rule.
    meshpath_rel = "antrea_tpu_torch/parallel/meshpath.py"
    try:
        wrules = world_migration(src)
    except (OSError, ValueError) as e:
        return problems + [f(str(e), "no-world-migration")]
    try:
        wsharded = sharded_world_fields(src)
    except (OSError, ValueError) as e:
        return problems + [f(str(e), "no-world-fields", meshpath_rel)]
    if not wsharded:
        problems.append(f(
            "no _TENANT_WORLD_FIELDS member of the mesh engine is assigned "
            "from a state builder — the parse is broken or the world "
            "state moved", "no-sharded-world-fields", meshpath_rel))
    for key in sorted(wsharded - set(wrules)):
        problems.append(f(
            f"{key} is a per-replica _TENANT_WORLD_FIELDS member of the "
            f"mesh engine but has NO rule in reshard.WORLD_MIGRATION — a "
            f"live resize would silently zero EVERY tenant world's copy "
            f"(flow loss); teach the per-world migrator and document the "
            f"rule", f"unmigrated-world:{key}"))
    for key in sorted(set(wrules) - wsharded):
        problems.append(f(
            f"WORLD_MIGRATION names {key!r}, which is not a per-replica "
            f"_TENANT_WORLD_FIELDS member — stale rule",
            f"stale-world:{key}"))
    for key, rule in wrules.items():
        if not (isinstance(rule, str) and rule.strip()):
            problems.append(f(
                f"WORLD_MIGRATION[{key!r}] carries no rule text",
                f"no-rule-world:{key}"))
    return problems
