"""The (data x rule) sharded step on torch.distributed (mesh.py), the
mesh engine over an in-process mesh (meshpath.py), its live resize
(reshard.py) and its replica-loss failover (failover.py)."""

from .mesh import (  # noqa: F401
    DEVICE_POOL,
    LocalMesh,
    gather_outputs,
    gather_state,
    local_mesh,
    make_mesh,
    make_sharded_classifier,
    make_sharded_pipeline,
    make_sharded_pipeline_full,
    mesh_devices,
    shard_of_tuples,
    shard_rule_set,
    shard_state,
    spawn,
)
from .meshpath import MeshDatapath, MeshSlowPath  # noqa: F401
from .reshard import RESHARD_MANIFEST, WORLD_MIGRATION, ReshardPlane  # noqa: F401
from .failover import FailoverPlane  # noqa: F401
