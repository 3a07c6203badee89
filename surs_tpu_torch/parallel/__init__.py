"""Multi-device paths on ``torch.distributed`` (counterpart of
``surs_tpu/parallel/``): one process per rank, NCCL on the card, gloo on
the CPU; the port's kernels run on every rank."""

from .mesh import (DATA_AXIS, POINT_AXIS, Mesh, make_mesh, batch_sharding,
                   replicated, point_sharding, shard, shard_batch,
                   replicate_tree)
from .sharded_mc import (extract_isosurface_sharded,
                         extract_isosurface_sharded_begin, gather_field)
from .single_subject import reconstruct_subject_sharded
from .batch_recon import ShardedReconstructor, shard_eval_fn_over_points

__all__ = [
    "DATA_AXIS", "POINT_AXIS", "make_mesh", "batch_sharding", "replicated",
    "point_sharding", "shard_batch", "replicate_tree",
    "extract_isosurface_sharded",
    "extract_isosurface_sharded_begin",
    "reconstruct_subject_sharded",
    "Mesh", "shard", "gather_field", "ShardedReconstructor",
    "shard_eval_fn_over_points",
]
