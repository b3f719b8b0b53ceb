"""The (data x rule) sharded step on torch.distributed (mesh.py) and the
mesh engine over an in-process mesh (meshpath.py)."""

from .mesh import (  # noqa: F401
    LocalMesh,
    gather_outputs,
    gather_state,
    local_mesh,
    make_mesh,
    make_sharded_classifier,
    make_sharded_pipeline,
    make_sharded_pipeline_full,
    shard_of_tuples,
    shard_rule_set,
    shard_state,
    spawn,
)
from .meshpath import MeshDatapath, MeshSlowPath  # noqa: F401
