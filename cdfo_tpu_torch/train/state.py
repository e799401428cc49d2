"""Training state, optimizer and the train step (``cdfo_tpu/train/state.py``).

The reference recipe (`train_LD_37.py:323-325,377`): Adam(lr=1e-4,
wd=1e-5) with torch's *coupled* weight decay (added to the gradient before
the moments; ``optax.add_decayed_weights`` then ``scale_by_adam`` in JAX),
MultiStepLR(milestones=[2000] epochs, gamma=0.5), Charbonnier (sum) on the
centre frame.

Under a bfloat16 model the optimizer updates float32 master copies of the
parameters, as ``cdfo_tpu``'s Adam updates its float32 params and casts
them at every use: Adam on bfloat16 weights would lose every update below
bfloat16's resolution. After each step the model's bfloat16 weights are
refreshed from the masters in place, which also bumps their versions, so
the fused trunk's kept weight packs are remade (``cuda_build.cached_pack``).

Data parallelism (``cdfo_tpu``'s multi-host run: one process per card
plays one JAX host): a ``TrainState`` built while a default process group
exists (``parallel.initialize_distributed``) starts from rank 0's
parameters, and each ``train_step`` runs on the rank's own rows. The loss is
a sum over rows, so the global batch's gradient is the sum of the ranks':
the float32 gradients that Adam reads, and the loss beside them, are summed
over the ranks in one flat all-reduce a step, and every rank then holds the
global loss, so the non-finite guard decides alike everywhere. Two ranks
equal one process on the concatenated batch.

Under a ``(data, spatial)`` mesh (``parallel.spatial.make_mesh``) a step
takes the rank's ``shard``: the batch holds the rank's rows of its data
share (``Mesh.split_batch``; ``hr`` at four times the rows), the forward
runs split (``sharded``), and the Charbonnier sum stays per rank. The
flat all-reduce over the whole world then sums the partial gradients of
both axes: every rank's gradient is that of its own rows' loss, through
the split's collectives, so their sum is the global batch's.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..losses import charbonnier_loss
from ..parallel.mesh import broadcast_module, shard_rows
from ..parallel.spatial import SpatialShard, sharded

MODEL_INPUTS = ("lrs", "mvs0", "mvs1", "pms", "rms", "ufs")


def make_schedule(cfg: TrainConfig, steps_per_epoch: int
                  ) -> Callable[[int], float]:
    """MultiStepLR over epochs, evaluated per update, as optax's
    ``piecewise_constant_schedule`` evaluates it: milestone m's factor
    applies from update index ``m * steps_per_epoch`` on (counted from 0)."""
    boundaries = sorted(m * steps_per_epoch for m in cfg.milestones)

    def schedule(count: int) -> float:
        return cfg.lr * cfg.gamma ** sum(1 for b in boundaries if count >= b)

    return schedule


class TrainState:
    """The model, the float32 master parameters, the Adam optimizer over
    them, the schedule and the update count ``step``.

    ``masters[i]`` is the model's i-th parameter itself where that is
    float32, else a float32 copy of it. Built on a rank of a process group,
    the state is data-parallel (``data_parallel``): the model first takes
    rank 0's parameters and buffers."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 steps_per_epoch: int = 1):
        self.data_parallel = dist.is_available() and dist.is_initialized()
        if self.data_parallel:
            broadcast_module(model)
        self.model = model
        self.cfg = cfg
        self.params = list(model.parameters())
        self.masters = [p if p.dtype == torch.float32
                        else p.detach().float().requires_grad_()
                        for p in self.params]
        self.schedule = make_schedule(cfg, steps_per_epoch)
        self.optimizer = torch.optim.Adam(
            self.masters, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def batch_to_device(self, batch: dict) -> dict:
        """The batch's arrays as float32 tensors on the model's device."""
        return {k: torch.as_tensor(v).to(self.device, torch.float32,
                                         non_blocking=True)
                for k, v in batch.items()}

    def _master_grads(self) -> list:
        """The masters' float32 gradients, moved there from the model's
        (a parameter without one takes zeros, as JAX's gradient of an unused
        parameter is zero, so its decay and moments still move); a master
        that holds its gradient already keeps it."""
        for p, m in zip(self.params, self.masters):
            if p.grad is not None:
                m.grad = p.grad if m is p else p.grad.float()
                if m is not p:
                    p.grad = None
            elif m.grad is None:
                m.grad = torch.zeros_like(m)
        return [m.grad for m in self.masters]

    def reduce_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """Sums the masters' float32 gradients and ``loss`` over the ranks
        in one flat all-reduce; returns the global loss."""
        grads = self._master_grads()
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().float().reshape(1)])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[-1]

    def apply_gradients(self) -> None:
        """One Adam update of the masters from the model's gradients
        (``_master_grads``), then the model's copies refreshed from the
        masters."""
        self._master_grads()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for p, m in zip(self.params, self.masters):
                if m is not p:
                    p.copy_(m)
        self.step += 1

    def state_dict(self) -> dict:
        """Everything a resumed run needs: the model's and the masters'
        values, the optimizer state and the step."""
        return {"model": self.model.state_dict(),
                "masters": [m.detach().clone() for m in self.masters],
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        with torch.no_grad():
            for m, saved in zip(self.masters, state["masters"]):
                m.copy_(saved)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def model_inputs(batch: dict) -> tuple:
    return tuple(batch[k] for k in MODEL_INPUTS)


def _draws_noise(model: torch.nn.Module) -> bool:
    """Whether the model's forward draws gumbel noise: the sampled EGLA
    mask on the compensated neighbours (woMV compensates none; woLA, woGA
    and no-EGLA mask nothing)."""
    egla = getattr(model, "RDAB", None)
    return model.cfg.use_mv and getattr(egla, "mask_mode", "") == "sample"


def _rank_noise(state: TrainState, batch: dict,
                generator: Optional[torch.Generator],
                gumbel_u: Optional[torch.Tensor],
                shard: Optional[SpatialShard] = None
                ) -> Optional[torch.Tensor]:
    """A data-parallel rank's rows of the global batch's gumbel draw: the
    neighbours of the rank's B samples, (B * (N - 1), H, W, nf), out of
    ``gumbel_u`` (the global draw, rank-major) or of a global draw from
    ``generator``, which every rank advances alike. Under a ``shard`` the
    rows follow its ``'data'`` index, and H its ``'spatial'`` one."""
    if not _draws_noise(state.model) or (gumbel_u is None and generator is None):
        return gumbel_u
    if shard is None:
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = shard.data_index, shard.data_size
    if gumbel_u is None:
        b, n, h, w, _ = batch["lrs"].shape
        h = h if shard is None else shard.height
        gumbel_u = torch.rand((world * b * (n - 1), h, w, state.model.cfg.nf),
                              generator=generator, device=state.device)
        gumbel_u.clamp_min_(torch.finfo(torch.float32).tiny)
    u = shard_rows(gumbel_u, rank, world)
    return u if shard is None else shard.take(u)


def train_step(state: TrainState, batch: dict,
               generator: Optional[torch.Generator] = None,
               gumbel_u: Optional[torch.Tensor] = None,
               shard: Optional[SpatialShard] = None) -> torch.Tensor:
    """One optimization step on ``batch`` (``batch['hr']`` the centre
    frame's ground truth (B, 4H, 4W, 1)); returns the loss, a float32
    scalar tensor. ``generator`` / ``gumbel_u``: the sampled EGLA mask's
    noise.

    Data-parallel (``state.data_parallel``): ``batch`` holds the rank's
    rows, ``gumbel_u`` (or the draw from ``generator``) covers the global
    batch, the ranks' rows in rank order, and the loss returned is the
    global one (``reduce_gradients``). ``shard``: the rank's rows of a
    ``(data, spatial)`` mesh (``Mesh.shard``); the batch then holds the
    rank's rows of H too, and the global draw covers the global H.

    Failure containment (`state.py:69-87` of ``cdfo_tpu``): a non-finite
    loss skips the update, so the parameters, the optimizer state and the
    step stay as they were."""
    batch = state.batch_to_device(batch)
    state.model.train()
    for p in state.params:
        p.grad = None
    if shard is not None and not state.data_parallel:
        raise ValueError("a split train step needs the ranks' process group")
    if state.data_parallel:
        gumbel_u = _rank_noise(state, batch, generator, gumbel_u, shard)
    with sharded(shard):
        sr, _ = state.model(*model_inputs(batch), generator=generator,
                            gumbel_u=gumbel_u)
    loss = charbonnier_loss(sr, batch["hr"])
    loss.backward()
    if state.data_parallel:
        loss = state.reduce_gradients(loss)
    if math.isfinite(loss.item()):
        state.apply_gradients()
    else:
        for p in state.params:
            p.grad = None
        state.optimizer.zero_grad(set_to_none=True)
    return loss.detach()
