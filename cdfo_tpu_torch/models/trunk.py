"""Cross-scale self-calibration reconstruction trunk, "CSSR" (counterpart
of ``BlockS`` / ``SCGroupS`` / ``SCNetS`` in ``cdfo_tpu/models/trunk.py``).

``BlockS`` runs a conv-lrelu-conv body at 1x, at 0.5x (down -> body -> up)
and at 2x (up -> body -> down), summing all three with the identity.
``SCGroupS`` stacks 3 of them + a 3x3 conv + skip; ``SCNetS`` stacks N
groups + skip. All resizes are bilinear, align_corners=False.

The pyramid (list-valued) twins ``BlockPyr`` / ``SCGroupPyr`` /
``SCNetPyr``, which CVSR_V7 and SIDECVSR run, exchange residuals across
three pyramid levels. ``SCNetSScan`` and ``SCNetPyrScan`` are the scan
trunks of ``cfg.scan_trunk``: the same parameters under the same names,
each group recomputed in the backward pass (``torch.utils.checkpoint``),
as JAX's ``nn.remat`` inside its ``nn.scan`` does, so that training keeps
only the groups' carries.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def _recomputed(group, *xs):
    """``group(*xs)``, its activations recomputed in the backward pass when
    autograd records it."""
    if torch.is_grad_enabled():
        return checkpoint(group, *xs, use_reentrant=False)
    return group(*xs)


class SCNetSScan(SCNetS):
    """``SCNetS`` with each group recomputed in the backward pass (JAX
    ``SCNetSScan``: ``nn.scan`` over ``nn.remat`` groups). Same math and
    ``state_dict``; ``compat.from_flax`` unstacks JAX's ``groups/g``
    tree."""

    def forward(self, x):
        r = x
        for group in self.body:
            r = _recomputed(group, r)
        return x + r


class BlockPyr(BlockS):
    """List-valued pyramid block (reference ``Block``): each level runs the
    shared body; level 0 adds its own body residual where the others add
    the down-projected residual of the finer level, and the last level its
    own where the others add the up-projected one of the coarser."""

    def forward(self, x_list):
        res = [self.body(t) for t in x_list]
        down = [res[0]] + [self.down(t) for t in res[:-1]]
        up = [self.up(t) for t in res[1:]] + [res[-1]]
        return [x + r + d + u for x, r, d, u in zip(x_list, res, down, up)]


class SCGroupPyr(nn.Module):
    def __init__(self, nf: int = 64, back_rbs: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.ModuleList(
            [BlockPyr(nf, dtype=dtype) for _ in range(back_rbs)])
        self.conv = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, *x_list):
        r = list(x_list)
        for block in self.body:
            r = block(r)
        return tuple(x + self.conv(t) for x, t in zip(x_list, r))


class SCNetPyr(nn.Module):
    def __init__(self, nf: int = 64, num_groups: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.ModuleList(
            [SCGroupPyr(nf, dtype=dtype) for _ in range(num_groups)])

    def _group(self, group, r):
        return group(*r)

    def forward(self, x_list):
        r = tuple(x_list)
        for group in self.body:
            r = self._group(group, r)
        return [x + t for x, t in zip(x_list, r)]


class SCNetPyrScan(SCNetPyr):
    """``SCNetPyr`` with each group recomputed in the backward pass (JAX
    ``SCNetPyrScan``); the three levels are the group's carry."""

    def _group(self, group, r):
        return _recomputed(group, *r)
