"""Multi-card paths (counterpart of ``cdfo_tpu/parallel``): the process
group (``mesh``), the ``'spatial'`` axis that splits frame rows over ranks
(``spatial``) and the sharded streaming engine (``serving``)."""
from .mesh import (all_gather_rows, broadcast_module, initialize_distributed,
                   rank_device, shard_rows)
from .spatial import (Mesh, SpatialShard, all_reduce_sum, gather_rows, halo,
                      make_mesh, sharded, split_rows)

__all__ = ["Mesh", "SpatialShard", "all_gather_rows", "all_reduce_sum",
           "broadcast_module", "gather_rows", "halo", "initialize_distributed",
           "make_mesh", "rank_device", "shard_rows", "sharded", "split_rows"]
