"""MV-guided temporal alignment (counterpart of the non-fused NHWC branch
of ``cdfo_tpu/models/alignment.py``).

``DualAttAlignment``: flow-warp the neighbour features by the motion-vector
field, fuse them with the unfiltered-prediction features, then two
cross-MSAs (q = center frame, k = fused, v = channel-gated warped / pred
features) sharing one gate, temperature and projection; aggregate with the
same ``fusion_out`` conv used for the warp fusion, then CALayer and two
residual blocks. The MSA's parameters live flat on the module
(``conv_du``, ``temperature``, ``project_out``), as in the reference
``state_dict``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.warp import flow_warp
from .attention import _channel_attention
from .layers import CALayer, Conv2d, ResidualBlockNoBN


class DualAttAlignment(nn.Module):
    """forward(x=center feat, extra_feat=neighbour feat, pred_feat, flow,
    warped_feat=None); flow (B, H, W, 2) pixel-unit (dx, dy). Streaming
    callers pass ``warped_feat`` precomputed from the ring."""

    def __init__(self, dim: int = 64, num_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.fusion_out = nn.Sequential(
            Conv2d(dim * 2, dim, 1, bias=False, dtype=dtype))
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.conv_du = nn.Sequential(
            Conv2d(dim, dim // 16, 1, dtype=dtype), nn.ReLU(),
            Conv2d(dim // 16, dim, 1, dtype=dtype), nn.Sigmoid())
        self.project_out = Conv2d(dim, dim, 1, bias=False, dtype=dtype)
        self.CALayer = CALayer(dim, dtype=dtype)
        self.ResidualBlock = ResidualBlockNoBN(dim, dtype=dtype)
        self.ResidualBlock1 = ResidualBlockNoBN(dim, dtype=dtype)

    def _gate_msa(self, q_in, k_in, vs):
        """The reference's two cross-MSAs share weights and (q, k), and
        attention and the bias-free projection are linear in v, so
        ``msa(q, k, v1) + msa(q, k, v2) == msa(q, k, (v1, v2))``: one
        attention on the sum of the gated values (JAX ``_GateMSA``)."""
        v_sum = None
        for v in vs:
            gv = v * self.conv_du(v.mean(dim=(1, 2), keepdim=True))
            v_sum = gv if v_sum is None else v_sum + gv
        return self.project_out(_channel_attention(
            q_in, k_in, v_sum, self.temperature, self.num_heads))

    def forward(self, x, extra_feat, pred_feat, flow, warped_feat=None):
        if warped_feat is None:
            warped_feat = flow_warp(extra_feat, flow)
        fused = torch.relu(self.fusion_out(
            torch.cat([warped_feat, pred_feat], dim=-1)))
        out = self._gate_msa(x, fused, (warped_feat, pred_feat))
        out = torch.relu(self.fusion_out(torch.cat([out, x], dim=-1)))
        out = self.ResidualBlock1(self.ResidualBlock(self.CALayer(out)))
        return out + x
