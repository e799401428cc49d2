"""Process-group helpers (counterpart of ``cdfo_tpu/parallel/mesh.py``; the
reference's ``init_dist`` / ``get_dist_info``, `opt/deep_learning.py:23-42`).

One process per card plays one JAX host: ``torchrun`` (or any launcher
with its contract: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) starts the ranks, and
``initialize_distributed`` joins them into the default process group, over
NCCL when the rank runs on a card and gloo on the CPU. ``broadcast_module``
is ``replicate``'s counterpart (every rank starts from rank 0's values),
``shard_rows`` ``shard_batch``'s (a rank's share of a leading axis), and
``all_gather_rows`` the collective of the sharded engine's step.

The JAX mesh's ``'spatial'`` axis (H sharded with halos that XLA inserts)
has no counterpart yet.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` on the card, else the CPU.
    Raises without CUDA when the card is asked for."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("a rank on the card needs CUDA and "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(device_type: str = "cuda") -> tuple[int, int]:
    """Joins this process to the default process group and returns
    ``(rank, world_size)``; a second call returns the group's without
    joining again. Rank and world come from the launcher's environment
    (``RANK``, ``WORLD_SIZE``); without them the process is a group of one
    on a free local port. The backend follows the rank's device
    (``rank_device``): NCCL on ``cuda:LOCAL_RANK``, to which the process is
    bound, gloo on the CPU."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = rank_device(device_type)
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if "MASTER_ADDR" in os.environ:
        init_method = "env://"
    elif world == 1:
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    else:
        raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR and "
                           "MASTER_PORT: start the ranks with torchrun")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world, **kwargs)
    return rank, world


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` takes rank ``src``'s value:
    one broadcast per dtype of a flat copy, written back in place (which
    bumps the tensors' versions, so no kept kernel pack goes stale)."""
    tensors = list(module.state_dict(keep_vars=True).values())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def shard_rows(x, rank: int, world: int):
    """Rank ``rank``'s contiguous share of ``x``'s leading axis (a tensor,
    an array or a list), whose length ``world`` must divide."""
    n = len(x)
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return x[rank * per:(rank + 1) * per]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (each the same shape and dtype) stacked along the
    leading axis in rank order, in one collective."""
    out = x.new_empty((dist.get_world_size() * x.shape[0],) + x.shape[1:])
    # all_gather_single takes over from all_gather_into_tensor (deprecated
    # in newer torch), which older ones have alone
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.contiguous())
    return out
