"""The CSSR trunk on the fused kernels (counterpart of
``cdfo_tpu/models/trunk_fast.py``): ``SCNetFast`` / ``_GroupFast`` /
``_BlockFast`` compute what ``SCNetS`` / ``SCGroupS`` / ``BlockS`` compute,
with each ``Block_`` one ``ops/fused_block2.scale_block`` call and each
group tail one ``ops/fused_groupconv.grouptail`` call. The outer ``x + r``
skip stays plain. ``use_int8`` makes each ``Block_`` one
``ops/fused_block2_q.scale_block_q`` call instead (the int8 trunk of
``ModelConfig.trunk_int8``; approximate, see that module).

Their ``state_dict`` keys are ``SCNetS``'s (``body.i.body.j.body.0.weight``
and so on): ``_BlockFast`` is a ``BlockS`` with another ``forward``, so
``from_flax`` loads the JAX fused and unfused trees (which are identical)
into either trunk, and one generator seed gives both trunks the same
weights.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda_build import cached_pack
from ..ops.fused_block2 import pack_weights, scale_block
from ..ops.fused_block2_q import pack_weights_q, scale_block_q
from ..ops.fused_groupconv import grouptail, pack_grouptail_weights
from .layers import Conv2d
from .trunk import BlockS


class _BlockFast(BlockS):
    """``BlockS`` through the fused Block_ kernel, or with ``use_int8``
    through its int8 twin (same parameters: the int8 weights are quantized
    when they are packed). The kernel's weight layouts (with the
    down2-folded conv2) are packed once and kept until a parameter changes
    (new storage or an in-place update); parameters made under
    ``torch.inference_mode`` are packed at every call. ``geometry``: the
    int8 plain version's step geometry on the CPU (None: the kernel's)."""

    geometry = None

    def __init__(self, nf: int = 64, dtype: torch.dtype = torch.float32,
                 use_int8: bool = False):
        super().__init__(nf, dtype=dtype)
        self.use_int8 = use_int8

    def _params(self):
        return (self.body[0].weight, self.body[0].bias, self.body[2].weight,
                self.body[2].bias, self.down[0].weight, self.down[0].bias,
                self.up[0].weight, self.up[0].bias)

    def _packed(self, x, params):
        pack = pack_weights_q if self.use_int8 else pack_weights
        return cached_pack(self, "_pack", x, params,
                           lambda dt: pack(*params, dt), self.use_int8)

    def forward(self, x):
        params = self._params()
        packed = self._packed(x, params)
        if self.use_int8:
            return scale_block_q(x, *params, packed=packed,
                                 geometry=self.geometry)
        return scale_block(x, *params, packed=packed)


class _GroupFast(nn.Module):
    """``SCGroupS``: the Block_s, then the group tail through
    ``grouptail``, whose packed conv weights are kept as the Block_s'
    are."""

    def __init__(self, nf: int = 64, back_rbs: int = 3,
                 dtype: torch.dtype = torch.float32, use_int8: bool = False):
        super().__init__()
        self.body = nn.Sequential(
            *[_BlockFast(nf, dtype=dtype, use_int8=use_int8)
              for _ in range(back_rbs)])
        self.conv = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        w = self.conv.weight
        packed = cached_pack(self, "_pack", x, (w,),
                             lambda dt: pack_grouptail_weights(w, dt))
        return grouptail(self.body(x), x, w, self.conv.bias, packed=packed)


class SCNetFast(nn.Module):
    """``SCNetS`` on the fused kernels; NHWC in and out."""

    def __init__(self, nf: int = 64, num_groups: int = 7,
                 dtype: torch.dtype = torch.float32, use_int8: bool = False):
        super().__init__()
        self.body = nn.Sequential(
            *[_GroupFast(nf, dtype=dtype, use_int8=use_int8)
              for _ in range(num_groups)])

    def set_int8_geometry(self, geometry) -> None:
        """The step geometry (``ops/fused_block2_q.StepGeometry``) the int8
        blocks' plain version walks on the CPU; None: the kernel's."""
        for m in self.modules():
            if isinstance(m, _BlockFast):
                m.geometry = geometry

    def forward(self, x):
        x = x.contiguous()
        return x + self.body(x)
