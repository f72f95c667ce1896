"""Data parallelism over ``torch.distributed``: the mesh and the sharded
training and detection that run on it."""

from superviseddescent_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather_rows, make_mesh, replicate, shard_batch)
from superviseddescent_tpu_torch.parallel.dist import (  # noqa: F401
    ShardedHogTransform, distributed_train_level,
    make_sharded_fused_detector, sharded_detect, sharded_detect_fused,
    sharded_learn)
