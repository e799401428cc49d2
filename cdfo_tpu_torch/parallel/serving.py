"""Sharded streaming serving (counterpart of ``cdfo_tpu/parallel/serving.py``):
the streaming engine over the ranks of the default process group, one card
each, the route past one card's throughput.

The k output frames of every step are split over the ranks: rank r stages,
uploads and computes centres ``j + r * k_per_device ..`` of step j, and
compensates their new frames. The kernels run unchanged per rank on whole
frames, so no halo is exchanged. The bootstrap is computed by every rank and
the three ring buffers are replicated; the step's one collective is an
``all_gather`` of the k new frames' compensated features (l1, fea_i and the
ufs prior, packed into one byte buffer), in rank order, so that every rank
writes the same k ring slots. The frames are the single engine's with
``k = k_per_device * world_size``: the same rings, the same per-frame
math.

Under ``mask_mode="sample"`` every rank's generator starts from the same
state (seeded with 0 unless one is given), as the JAX engine hands every
chip the same key: the bootstrap draws the same noise on every rank, and
each step's draw covers the rank's own ``k_per_device`` frames, so rank r's
frames take the draw that rank 0's take, not the single engine's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..infer.engine import BatchedStreamingEngine
from .mesh import all_gather_rows, broadcast_module, shard_rows


class ShardedServingEngine(BatchedStreamingEngine):
    """``BatchedStreamingEngine`` with the k-frame axis split over the ranks
    of the default process group (``parallel.initialize_distributed``),
    ``k_per_device`` frames a rank a step; the model's parameters are
    broadcast from rank 0 first.

    ``run_sequence`` returns the whole sequence's uint8 frames
    ``(T, sH, sW)`` on every rank (each step's frames are gathered after
    the step) and, timed, the fps that rank measured: every rank stages its
    inputs, then a barrier starts the timer and another, after one
    synchronize, ends it, so the ranks time the same window; rank 0's is
    the one to report."""

    def __init__(self, model, k_per_device: int = 2, nframes: int = 7,
                 generator: torch.Generator | None = None):
        if not dist.is_initialized():
            raise RuntimeError("ShardedServingEngine runs over the default "
                               "process group: call "
                               "parallel.initialize_distributed() first")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.k_per_device = k_per_device
        broadcast_module(model)
        super().__init__(model, k=k_per_device * self.world, nframes=nframes,
                         generator=generator)

    def _own(self, centers: list) -> list:
        return shard_rows(centers, self.rank, self.world)

    def _gather(self, feats):
        rows = feats[0].shape[0]
        packed = torch.cat([f.reshape(rows, -1).view(torch.uint8)
                            for f in feats], dim=1)
        gathered = all_gather_rows(packed)
        out, offset = [], 0
        for f in feats:
            size = f[0].numel() * f.element_size()
            out.append(gathered[:, offset:offset + size].view(f.dtype)
                       .reshape((self.k,) + f.shape[1:]))
            offset += size
        return out

    def _sync(self):
        super()._sync()
        dist.barrier()

    def _fetch(self, sr8):
        return super()._fetch(all_gather_rows(sr8))
