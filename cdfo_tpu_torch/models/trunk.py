"""Cross-scale self-calibration reconstruction trunk, "CSSR" (counterpart
of ``BlockS`` / ``SCGroupS`` / ``SCNetS`` in ``cdfo_tpu/models/trunk.py``).

``BlockS`` runs a conv-lrelu-conv body at 1x, at 0.5x (down -> body -> up)
and at 2x (up -> body -> down), summing all three with the identity.
``SCGroupS`` stacks 3 of them + a 3x3 conv + skip; ``SCNetS`` stacks N
groups + skip. All resizes are bilinear, align_corners=False.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import interpolate_bilinear
from .layers import Conv2d


class Interpolate(nn.Module):
    """Bilinear resize by a scale factor (the reference's ``Interpolate``)."""

    def __init__(self, scale_factor: float):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x):
        return interpolate_bilinear(x, scale_factor=self.scale_factor)


class BlockS(nn.Module):
    def __init__(self, nf: int = 64, kernel_size: int = 3,
                 width_multiplier: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.body = nn.Sequential(
            Conv2d(nf, nf * width_multiplier, k, 1, k // 2, init_scale=0.1,
                   dtype=dtype),
            nn.LeakyReLU(0.1),
            Conv2d(nf * width_multiplier, nf, k, 1, k // 2, init_scale=0.1,
                   dtype=dtype))
        self.down = nn.Sequential(
            Conv2d(nf, nf, 1, init_scale=0.1, dtype=dtype), Interpolate(0.5))
        self.up = nn.Sequential(
            Conv2d(nf, nf, 1, init_scale=0.1, dtype=dtype), Interpolate(2.0))

    def forward(self, x):
        r = self.body(x)
        down_res = self.up(self.body(self.down(x)))
        up_res = self.down(self.body(self.up(x)))
        return x + r + down_res + up_res


class SCGroupS(nn.Module):
    def __init__(self, nf: int = 64, back_rbs: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.Sequential(
            *[BlockS(nf, dtype=dtype) for _ in range(back_rbs)])
        self.conv = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        return x + self.conv(self.body(x))


class SCNetS(nn.Module):
    def __init__(self, nf: int = 64, num_groups: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.Sequential(
            *[SCGroupS(nf, dtype=dtype) for _ in range(num_groups)])

    def forward(self, x):
        return x + self.body(x)
