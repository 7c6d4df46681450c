r"""Multi-device execution: sharded clustering over a mesh of devices."""

from bblean_tpu_torch.parallel.mesh import Mesh, get_mesh
from bblean_tpu_torch.parallel.sharded import (
    ShardedClusters,
    ShardedForest,
    sharded_fit,
)

__all__ = ["Mesh", "get_mesh", "sharded_fit", "ShardedClusters", "ShardedForest"]
