"""The (data x rule) sharded step on torch.distributed (mesh.py)."""

from .mesh import (  # noqa: F401
    gather_outputs,
    gather_state,
    make_mesh,
    make_sharded_classifier,
    make_sharded_pipeline,
    make_sharded_pipeline_full,
    shard_of_tuples,
    shard_rule_set,
    shard_state,
    spawn,
)


class MeshDatapath:
    """The mesh engine (the JAX package's parallel/meshpath.MeshDatapath)
    is not ported yet: constructing it raises NotImplementedError."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("MeshDatapath is not ported yet "
                                  "(ROADMAP.md queue A item 7)")
