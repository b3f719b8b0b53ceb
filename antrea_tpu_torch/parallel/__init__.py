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
