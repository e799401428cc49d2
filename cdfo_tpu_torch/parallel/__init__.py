"""Multi-card paths (counterpart of ``cdfo_tpu/parallel``): the process
group (``mesh``) and the sharded streaming engine (``serving``)."""
from .mesh import (all_gather_rows, broadcast_module, initialize_distributed,
                   rank_device, shard_rows)

__all__ = ["all_gather_rows", "broadcast_module", "initialize_distributed",
           "rank_device", "shard_rows"]
