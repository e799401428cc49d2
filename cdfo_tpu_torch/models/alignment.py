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

The wo-MV ablation (``use_mv=False``) keeps only the prediction-feature
MSA (k = pred, unfused), the wo-Pd one (``use_pd=False``) only the warped
MSA (k = warped); both then run the same aggregation and tail.

With ``center`` given (the ``fused_trunk`` path), the tail after the
CALayer gate is one ``ops/fused_tail.resblock_pair`` call, which applies the
gate and adds ``center[b // nbr]`` itself (JAX ``_fast_tail``); its
weights are packed once for the kernel and kept until a parameter changes
(new storage or an in-place update); parameters made under
``torch.inference_mode`` are packed at every call.
``fused_msa`` (the ``fused_align`` path) runs the whole dual MSA as the two
passes of ``ops/fused_align`` and then that tail (JAX ``_fused_msa``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda_build import cached_pack
from ..ops.fused_align import msa_stage1, msa_stage2, pack_stage2_weights
from ..ops.fused_mdta import attention_matrix
from ..ops.fused_tail import pack_tail_weights, resblock_pair
from ..ops.warp import flow_warp
from ..parallel import spatial
from .attention import _channel_attention
from .layers import CALayer, Conv2d, ResidualBlockNoBN


class DualAttAlignment(nn.Module):
    """forward(x=center feat, extra_feat=neighbour feat, pred_feat, flow,
    warped_feat=None, center=None); flow (B, H, W, 2) pixel-unit (dx, dy).
    Streaming callers pass ``warped_feat`` precomputed from the ring, and on
    the fused path ``center`` (B // nbr, H, W, C), the distinct centre
    frames that ``x`` repeats."""

    def __init__(self, dim: int = 64, num_heads: int = 4,
                 use_mv: bool = True, use_pd: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.use_mv, self.use_pd = use_mv, use_pd
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
            gv = v * self.conv_du(spatial.spatial_mean(v, tag="gate_mean"))
            v_sum = gv if v_sum is None else v_sum + gv
        return self.project_out(_channel_attention(
            q_in, k_in, v_sum, self.temperature, self.num_heads))

    def _tail_params(self):
        rb1, rb2 = self.ResidualBlock, self.ResidualBlock1
        return (rb1.conv1.weight, rb1.conv1.bias, rb1.conv2.weight,
                rb1.conv2.bias, rb2.conv1.weight, rb2.conv1.bias,
                rb2.conv2.weight, rb2.conv2.bias)

    def _tail(self, out, center, gate):
        """RB2(RB1(gate * out)) + center[b // nbr], one kernel call."""
        params = self._tail_params()
        return resblock_pair(
            out.contiguous(), center.contiguous(), gate.contiguous(),
            *params, packed=cached_pack(
                self, "_tail_pack", out, params,
                lambda dt: pack_tail_weights(params[0::2], params[1::2], dt)))

    def fused_msa(self, warped, pred, center):
        """The aligned features of ``forward`` with ``center`` given, by the
        fused dual MSA: warped, pred (B, H, W, C) neighbour features,
        center (B // nbr, H, W, C) the distinct centre frames, never
        broadcast. The gates fold into the attention matrix: A (g_w w + g_p
        p) = (A diag(g_w)) w + (A diag(g_p)) p."""
        dt = warped.dtype
        npix = float(warped.shape[1] * warped.shape[2])
        w_fuse = self.fusion_out[0].weight
        warped, pred, center = (t.contiguous() for t in (warped, pred,
                                                           center))
        stats, gaps = msa_stage1(warped, pred, center, w_fuse)
        amat = attention_matrix(stats, self.temperature,
                                self.num_heads).to(dt)

        def gate(conv_du, sums):   # on the (B, C) mean, in the compute dtype
            return conv_du((sums / npix).to(dt)[:, None, None, :]).flatten(1)

        gw, gp = gate(self.conv_du, gaps[:, 0]), gate(self.conv_du, gaps[:, 1])
        awt = (amat * gw[:, None, :]).transpose(1, 2).contiguous()
        apt = (amat * gp[:, None, :]).transpose(1, 2).contiguous()
        w_proj = self.project_out.weight
        fo, gap2 = msa_stage2(
            warped, pred, center, awt, apt, w_proj, w_fuse,
            packed=cached_pack(
                self, "_msa2_pack", warped, (w_proj, w_fuse),
                lambda dt: pack_stage2_weights(w_proj, w_fuse, dt)))
        return self._tail(fo, center, gate(self.CALayer.conv_du, gap2))

    def forward(self, x, extra_feat, pred_feat, flow, warped_feat=None,
                center=None):
        if not self.use_mv:       # woMV: extra_feat and flow unread
            out = self._gate_msa(x, pred_feat, (pred_feat,))
        else:
            if warped_feat is None:
                warped_feat = flow_warp(extra_feat, flow)
            if not self.use_pd:   # woPd: pred_feat unread
                out = self._gate_msa(x, warped_feat, (warped_feat,))
            else:
                fused = torch.relu(self.fusion_out(
                    torch.cat([warped_feat, pred_feat], dim=-1)))
                out = self._gate_msa(x, fused, (warped_feat, pred_feat))
        out = torch.relu(self.fusion_out(torch.cat([out, x], dim=-1)))
        if center is not None:
            gate = self.CALayer.conv_du(out.mean(dim=(1, 2), keepdim=True))
            return self._tail(out, center, gate.reshape(gate.shape[0], -1))
        out = self.ResidualBlock1(self.ResidualBlock(self.CALayer(out)))
        return out + x
