from fesom2_accelerate_tpu_torch.parallel import distributed
from fesom2_accelerate_tpu_torch.parallel.partition import (
    PartitionedMesh,
    partition_mesh,
)
from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
    ShardedFctAleSolver,
)

__all__ = [
    "PartitionedMesh",
    "ShardedFctAleSolver",
    "distributed",
    "partition_mesh",
]
