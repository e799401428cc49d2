"""Learning-rate schedules as plain step -> lr functions
(``cdfo_tpu/train/schedules.py``): the restart variants of the reference's
latent distributed module (`opt/deep_learning.py:246-358`). The trainer's
MultiStepLR is ``train/state.py::make_schedule``."""
from __future__ import annotations

import math
from typing import Callable, Sequence


def multi_step_restart_lr(base_lr: float, milestones: Sequence[int],
                          gamma: float = 0.1,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1.0,)
                          ) -> Callable[[int], float]:
    """MultiStepRestartLR (`opt/deep_learning.py:246-286`): lr decays by
    gamma at each milestone and resets to base * weight at each restart."""
    assert len(restarts) == len(restart_weights)
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        last_restart, weight = 0, 1.0
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                last_restart, weight = r, w
        decays = sum(1 for m in milestones if step >= m > last_restart)
        return base_lr * weight * gamma ** decays

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1.0,),
                                eta_min: float = 0.0
                                ) -> Callable[[int], float]:
    """CosineAnnealingRestartLR (`opt/deep_learning.py:310-358`)."""
    assert len(periods) == len(restart_weights)

    def schedule(step: int) -> float:
        lr, start = eta_min, 0
        for ci, (period, weight) in enumerate(zip(periods, restart_weights)):
            end = start + period
            # a period's end belongs to the earlier cycle, as the
            # reference's right-closest search has it
            # (`opt/deep_learning.py:289-307`)
            if (step >= 0 if ci == 0 else step > start) and step <= end:
                lr = eta_min + weight * 0.5 * (base_lr - eta_min) * (
                    1 + math.cos(math.pi * (step - start) / period))
            start = end
        return lr

    return schedule
