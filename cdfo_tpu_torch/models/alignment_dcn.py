"""The deformable-conv and patch-attention alignment that CVSR_V7 and
SIDECVSR run (counterparts of ``cdfo_tpu/models/alignment_dcn.py``), NHWC.
Flows are (dx, dy) in the channels; deformable offsets follow
``ops/deform_conv`` ([dy, dx] per tap, deformable group major), so the
reference's ``flow.flip(1).repeat(GK)`` bias is a (dy, dx) tile here.

* ``MVDualAttAlignment`` (V7's aligner, `:3265-3352`): two channel MSAs
  predict offset fields through one shared head, summed with the tiled
  flow; masks summed, then sigmoided; a modulated DCN with 16 deformable
  groups. Its parameters sit flat on the module, as in the reference's
  ``state_dict`` (the DCN's raw ``weight`` and ``bias`` too).
* ``STN``, ``MVLocalAttn`` and ``FeaFusion`` (SIDECVSR's patch alignment
  and temporal attention, `:200-320`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.deform_conv import deform_conv2d
from ..ops.warp import flow_warp
from .attention import _channel_attention
from .dcn import ZeroConv2d, _ref_weight_init
from .layers import Conv2d


def _tile_flow_bias(flow: torch.Tensor, gk: int) -> torch.Tensor:
    """flow (B, H, W, 2) = [dx, dy] -> (B, H, W, 2 * gk) [dy, dx] per tap
    (the reference's ``flow_1.flip(1).repeat(1, GK, 1, 1)``, `:3159`)."""
    return flow.flip(-1).repeat(1, 1, 1, gk)


class _ChannelMSA(nn.Module):
    """The family's channel MSA (q and k L2-normalised over pixels, a
    temperature per head, a bias-free 1x1 projection), as a base class:
    its ``temperature`` and ``project_out`` are the subclass's own
    parameters, flat on the module, as the reference keeps them."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.project_out = Conv2d(dim, dim, 1, bias=False, dtype=dtype)

    def msa(self, q_in, k_in, v_in):
        return self.project_out(_channel_attention(
            q_in, k_in, v_in, self.temperature, self.num_heads))


class MVDualAttAlignment(_ChannelMSA):
    """forward(x=centre feature, extra_feat=neighbour feature, pred_feat,
    flow (B, H, W, 2) pixel-unit (dx, dy)): the neighbour warped by the
    flow and fused with the prediction feature is the key of two channel
    MSAs on the gated warped and prediction features; each result's offset
    head gives 2*G*K offsets (10 tanh) and G*K mask logits; the DCN samples
    ``x`` at the summed offsets plus the tiled flow."""

    def __init__(self, dim: int = 64, kernel_size: int = 3, padding: int = 1,
                 deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, num_heads, dtype)
        self.dim, self.kernel_size, self.padding = dim, kernel_size, padding
        self.deformable_groups = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        k, g = kernel_size, deformable_groups
        self.fusion_out = Conv2d(2 * dim, dim, 1, bias=False, dtype=dtype)
        self.conv_du = nn.Sequential(
            Conv2d(dim, dim // 16, 1, dtype=dtype), nn.ReLU(),
            Conv2d(dim // 16, dim, 1, dtype=dtype), nn.Sigmoid())
        self.conv_offset = nn.Sequential(
            Conv2d(dim, dim, 3, 1, 1, dtype=dtype), nn.LeakyReLU(0.1),
            ZeroConv2d(dim, 3 * g * k * k, 3, 1, 1, dtype=dtype))
        self.weight = nn.Parameter(torch.empty(dim, dim, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def init_parameters(self, generator: torch.Generator):
        _ref_weight_init(self.weight, self.dim, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, extra_feat, pred_feat, flow):
        gk = self.deformable_groups * self.kernel_size ** 2
        warped = flow_warp(extra_feat, flow)
        fused = self.fusion_out(torch.cat([warped, pred_feat], dim=-1))

        def gate(v):
            return v * self.conv_du(v.mean(dim=(1, 2), keepdim=True))

        co1 = self.conv_offset(self.msa(x, fused, gate(warped)))
        co2 = self.conv_offset(self.msa(x, fused, gate(pred_feat)))
        mag = self.max_residue_magnitude
        offset = (mag * torch.tanh(co1[..., :2 * gk])
                  + mag * torch.tanh(co2[..., :2 * gk])
                  + _tile_flow_bias(flow, gk))
        mask = torch.sigmoid(co1[..., 2 * gk:] + co2[..., 2 * gk:])
        return deform_conv2d(x, offset, self.weight, self.bias, mask,
                             padding=self.padding)


class STN(nn.Module):
    """The reference's normalised-grid warper (`:200-216`): flows in pixels
    / 32, the sample grid clamped to [-1, 1], border padding. No
    parameters. The clamp keeps every sample inside the image, where zero
    and border padding read the same taps, so ``flow_warp``'s zero padding
    serves."""

    def forward(self, inputs, u, v):
        """inputs (B, H, W, C); u, v (B, H, W) flow components."""
        _, h, w, _ = inputs.shape
        dev = inputs.device
        nu = (u / w * 2.0) * 32.0
        nv = (v / h * 2.0) * 32.0
        gx = torch.arange(w, device=dev, dtype=torch.float32) \
            / max(w - 1, 1) * 2.0 - 1.0
        gy = torch.arange(h, device=dev, dtype=torch.float32) \
            / max(h - 1, 1) * 2.0 - 1.0
        mx = (gx[None, None, :] + nu.float()).clamp(-1, 1)
        my = (gy[None, :, None] + nv.float()).clamp(-1, 1)
        px = (mx + 1.0) * (w - 1) / 2.0
        py = (my + 1.0) * (h - 1) / 2.0
        base_x = torch.arange(w, device=dev, dtype=torch.float32)
        base_y = torch.arange(h, device=dev, dtype=torch.float32)
        flow = torch.stack([px - base_x[None, None, :],
                            py - base_y[None, :, None]], dim=-1)
        return flow_warp(inputs, flow)


def _unfold(t, k):
    """(B, H, W, C) -> (B, H, W, C, k*k): the zero-padded k x k patch of
    every pixel, in torch ``Unfold``'s (C, ky, kx) channel order."""
    _, h, w, _ = t.shape
    p = k // 2
    pads = torch.nn.functional.pad(t, (0, 0, p, p, p, p))
    return torch.stack([pads[:, dy:dy + h, dx:dx + w, :]
                        for dy in range(k) for dx in range(k)], dim=-1)


class MVLocalAttn(nn.Module):
    """MV_LOCAL_ATTN (`:219-250`): the neighbour's 3x3 patches warped by the
    MV (``STN``, border padding), a 9-way softmax kernel predicted from them
    and the centre's patches, the weighted mean of the warped patch.
    forward(nbh_fea, cen_fea, mv)."""

    def __init__(self, nf: int = 64, p_k: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.p_k = p_k
        kk = p_k * p_k
        self.warp_module = STN()
        self.kernel_pred_module = nn.Sequential(
            Conv2d(2 * nf * kk, 2 * nf, 1, dtype=dtype), nn.LeakyReLU(0.1),
            Conv2d(2 * nf, kk, 1, dtype=dtype))

    def forward(self, nbh_fea, cen_fea, mv):
        b, h, w, c = cen_fea.shape
        kk = self.p_k ** 2
        nbh_flat = _unfold(nbh_fea, self.p_k).reshape(b, h, w, c * kk)
        warped = self.warp_module(nbh_flat, mv[..., 0], mv[..., 1])
        cen_flat = _unfold(cen_fea, self.p_k).reshape(b, h, w, c * kk)
        attn = torch.softmax(self.kernel_pred_module(
            torch.cat([warped, cen_flat], dim=-1)), dim=-1)
        return (warped.reshape(b, h, w, c, kk)
                * attn[:, :, :, None, :]).mean(dim=-1)


class FeaFusion(nn.Module):
    """fea_fusion (`:296-320`): each frame's embedding correlated with the
    centre's, sigmoided, gates that frame's channels. Input and output
    (B, H, W, N*nf), frame-major channels."""

    def __init__(self, nf: int = 64, n: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nf, self.n = nf, n
        self.q = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)
        self.p = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, feas):
        b, h, w, nc = feas.shape
        n, nf = self.n, self.nf
        frames = feas.reshape(b, h, w, n, nf).permute(0, 3, 1, 2, 4)
        emb = self.q(frames.reshape(b * n, h, w, nf)).reshape(b, n, h, w, nf)
        emb_ref = self.p(emb[:, n // 2])
        prob = torch.sigmoid((emb * emb_ref[:, None]).sum(dim=-1))
        prob = prob.permute(0, 2, 3, 1)[..., None].expand(b, h, w, n, nf)
        return feas * prob.reshape(b, h, w, nc)
