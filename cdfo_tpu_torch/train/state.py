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
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..config import TrainConfig
from ..losses import charbonnier_loss

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
    float32, else a float32 copy of it."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 steps_per_epoch: int = 1):
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

    def apply_gradients(self) -> None:
        """One Adam update of the masters from the model's gradients (a
        parameter without one takes zeros, as JAX's gradient of an unused
        parameter is zero, so its decay and moments still move), then the
        model's copies refreshed from the masters."""
        for p, m in zip(self.params, self.masters):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if m is not p:
                p.grad = None
                g = g.float()
            m.grad = g
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


def train_step(state: TrainState, batch: dict,
               generator: Optional[torch.Generator] = None,
               gumbel_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One optimization step on ``batch`` (``batch['hr']`` the centre
    frame's ground truth (B, 4H, 4W, 1)); returns the loss, a float32
    scalar tensor. ``generator`` / ``gumbel_u``: the sampled EGLA mask's
    noise.

    Failure containment (`state.py:69-87` of ``cdfo_tpu``): a non-finite
    loss skips the update, so the parameters, the optimizer state and the
    step stay as they were."""
    batch = state.batch_to_device(batch)
    state.model.train()
    for p in state.params:
        p.grad = None
    sr, _ = state.model(*model_inputs(batch), generator=generator,
                        gumbel_u=gumbel_u)
    loss = charbonnier_loss(sr, batch["hr"])
    loss.backward()
    if math.isfinite(loss.item()):
        state.apply_gradients()
    else:
        for p in state.params:
            p.grad = None
    return loss.detach()
