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
* The library members no registry model builds: ``MVDeformableAlignment``,
  ``MVSelfAttDeformableAlignment``, ``MVIterativeDeformableAlignment``
  (offsets from a conv head over the warped neighbour), and the STDF-era
  ``DeformableSKConv`` and ``STDF``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.deform_conv import deform_conv2d
from ..ops.warp import flow_warp
from .attention import _channel_attention
from .dcn import ZeroConv2d, _ref_weight_init
from .layers import Conv2d, DPConv, lrelu


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


def _offset_head(in_ch: int, dim: int, out_ch: int, dtype) -> nn.Sequential:
    """``conv_offset``: three 3x3 convs, each followed by lrelu(0.1), then
    a zero-initialised 3x3 conv to ``out_ch`` (``conv_offset.0`` ...
    ``conv_offset.6``)."""
    return nn.Sequential(
        Conv2d(in_ch, dim, 3, 1, 1, dtype=dtype), nn.LeakyReLU(0.1),
        Conv2d(dim, dim, 3, 1, 1, dtype=dtype), nn.LeakyReLU(0.1),
        Conv2d(dim, dim, 3, 1, 1, dtype=dtype), nn.LeakyReLU(0.1),
        ZeroConv2d(dim, out_ch, 3, 1, 1, dtype=dtype))


class _MVDeformable(nn.Module):
    """The three MV deformable aligners' shared part: the offset head, the
    modulated DCN's raw ``weight`` and ``bias`` flat on the module, and
    ``_align``, which turns the head's output into offsets (10 tanh plus
    the tiled flow) and a sigmoid mask and samples ``x``."""

    def __init__(self, dim: int, head_in: int, kernel_size: int,
                 padding: int, deformable_groups: int,
                 max_residue_magnitude: float, dtype: torch.dtype):
        super().__init__()
        self.dim, self.kernel_size, self.padding = dim, kernel_size, padding
        self.deformable_groups = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        k, g = kernel_size, deformable_groups
        self.conv_offset = _offset_head(head_in, dim, 3 * g * k * k, dtype)
        self.weight = nn.Parameter(torch.empty(dim, dim, k, k, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def init_parameters(self, generator: torch.Generator):
        _ref_weight_init(self.weight, self.dim, generator)
        with torch.no_grad():
            self.bias.zero_()

    def _offsets(self, out):
        """(10 tanh of the head's offsets, its sigmoid mask)."""
        gk = self.deformable_groups * self.kernel_size ** 2
        return (self.max_residue_magnitude * torch.tanh(out[..., :2 * gk]),
                torch.sigmoid(out[..., 2 * gk:]))

    def _align(self, x, residue, mask, flow):
        gk = self.deformable_groups * self.kernel_size ** 2
        return deform_conv2d(x, residue + _tile_flow_bias(flow, gk),
                             self.weight, self.bias, mask,
                             padding=self.padding)


class MVDeformableAlignment(_MVDeformable):
    """`:3103-3165`: offsets from ``conv_offset`` over the warped neighbour
    and the flow (twice), 10 tanh plus the tiled flow; the mask a sigmoid
    (the reference's ``nn.Sigmoid(mask)`` constructs a module and would
    crash; ``cdfo_tpu`` applies the function, and so does the port).
    forward(x, extra_feat, flow)."""

    def __init__(self, dim: int = 64, kernel_size: int = 3, padding: int = 1,
                 deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, dim + 4, kernel_size, padding,
                         deformable_groups, max_residue_magnitude, dtype)

    def forward(self, x, extra_feat, flow):
        warped = flow_warp(extra_feat, flow)
        residue, mask = self._offsets(
            self.conv_offset(torch.cat([warped, flow, flow], dim=-1)))
        return self._align(x, residue, mask, flow)


class MVSelfAttDeformableAlignment(_MVDeformable):
    """`:3169-3261`: the reference computes a channel MSA of (warped,
    extra_feat, pred_feat) and then overwrites its result (`:3246`); the
    offsets come from ``conv_offset(extra_feat)``. The MSA's parameters
    (``temperature``, ``project_out``) are kept, so checkpoints load; its
    discarded output is not computed. forward(x, extra_feat, pred_feat,
    flow)."""

    def __init__(self, dim: int = 64, kernel_size: int = 3, padding: int = 1,
                 deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, dim, kernel_size, padding, deformable_groups,
                         max_residue_magnitude, dtype)
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.project_out = Conv2d(dim, dim, 1, bias=False, dtype=dtype)

    def forward(self, x, extra_feat, pred_feat, flow):
        residue, mask = self._offsets(self.conv_offset(extra_feat))
        return self._align(x, residue, mask, flow)


class MVIterativeDeformableAlignment(_MVDeformable):
    """`:3653-3736`: iterative offset refinement. Without a carried offset
    feature the head reads (warped, flow, flow); with one, (warped,
    sigmoid(off2flow(pre * sigmoid(scaleing(warped, pre))))). Returns
    (aligned, offset feature = sigmoid(offset_oc(the tanh offsets))).
    forward(x, extra_feat, flow, pre_offset_fea=None)."""

    def __init__(self, dim: int = 64, kernel_size: int = 3, padding: int = 1,
                 deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, dim + 4, kernel_size, padding,
                         deformable_groups, max_residue_magnitude, dtype)
        gk = deformable_groups * kernel_size ** 2
        self.scaleing = nn.Sequential(
            Conv2d(2 * dim, dim, 3, 1, 1, dtype=dtype))
        self.off2flow = nn.Sequential(Conv2d(dim, 4, 3, 1, 1, dtype=dtype))
        self.offset_oc = nn.Sequential(
            Conv2d(2 * gk, dim, 3, 1, 1, dtype=dtype))

    def forward(self, x, extra_feat, flow, pre_offset_fea=None):
        warped = flow_warp(extra_feat, flow)
        if pre_offset_fea is None:
            feat = torch.cat([warped, flow, flow], dim=-1)
        else:
            scale = torch.sigmoid(self.scaleing(
                torch.cat([warped, pre_offset_fea], dim=-1)))
            pre = torch.sigmoid(self.off2flow(pre_offset_fea * scale))
            feat = torch.cat([warped, pre], dim=-1)
        residue, mask = self._offsets(self.conv_offset(feat))
        offset_out = torch.sigmoid(self.offset_oc(residue))
        return self._align(x, residue, mask, flow), offset_out


class DeformableSKConv(nn.Module):
    """deformable_SKConv (`:62-128`): branches of kernel 1, 3 and 5, each
    a modulated DCN with one deformable group per channel whose offsets
    (from a ``DPConv`` head) start at the tiled motion vector; the shared
    ``conv_attention`` / ``fc`` give each branch a GAP gate; the gated
    branches, concatenated branch-major, go through a 1x1 conv. The DCNs'
    raw weights are ``deform_weight_{i}`` / ``deform_bias_{i}``.
    forward(fea, inputs, mv)."""

    def __init__(self, in_fea: int = 64, out_fea: int = 64, in_nc: int = 32,
                 branches: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        nc = in_nc
        self.in_nc, self.branches = nc, branches
        self.input_conv = nn.Sequential(Conv2d(in_fea, nc, 1, dtype=dtype))
        self.conv_attention = nn.Sequential(Conv2d(nc, nc, 1, dtype=dtype))
        self.fc = nn.Sequential(Conv2d(nc, nc, 1, dtype=dtype))
        self.offset_mask = nn.ModuleList(
            [DPConv(nc, nc * 3 * (2 * i + 1) ** 2, 2 * i + 1, dtype=dtype)
             for i in range(branches)])
        for i in range(branches):
            k = 2 * i + 1
            self.register_parameter(f"deform_weight_{i}", nn.Parameter(
                torch.empty(nc, nc, k, k, dtype=dtype)))
            self.register_parameter(f"deform_bias_{i}", nn.Parameter(
                torch.zeros(nc, dtype=dtype)))
        self.conv_0 = Conv2d(branches * nc, out_fea, 1, dtype=dtype)

    def init_parameters(self, generator: torch.Generator):
        for i in range(self.branches):
            _ref_weight_init(getattr(self, f"deform_weight_{i}"), self.in_nc,
                             generator)
            with torch.no_grad():
                getattr(self, f"deform_bias_{i}").zero_()

    def forward(self, fea, inputs, mv):
        nc = self.in_nc
        head_in = lrelu(self.input_conv(fea))
        dcn_in = lrelu(self.input_conv(inputs))
        outs = []
        for i in range(self.branches):
            k = 2 * i + 1
            d = k * k
            om = self.offset_mask[i](head_in)
            offset = om[..., :nc * 2 * d] + _tile_flow_bias(mv, nc * d)
            fused = torch.relu(deform_conv2d(
                dcn_in, offset, getattr(self, f"deform_weight_{i}"),
                getattr(self, f"deform_bias_{i}"),
                torch.sigmoid(om[..., nc * 2 * d:]), padding=k // 2))
            att = lrelu(self.conv_attention(fused)).mean(dim=(1, 2),
                                                         keepdim=True)
            outs.append(fused * lrelu(self.fc(att)))
        return lrelu(self.conv_0(torch.cat(outs, dim=-1)))


class STDF(_ChannelMSA):
    """Spatio-temporal deformable fusion (`:134-188`): the channel MSA of
    (warped neighbour, neighbour, prediction), its 1x1 and 3x3
    projections feeding ``DeformableSKConv`` (``d_SKConv``) with the
    motion vector. ``project_out_5`` is built but its output unused, as in
    the reference; the port keeps its parameters and skips the conv.
    forward(inputs, extra_feat, pred_feat, mv); ``inputs`` is not read."""

    def __init__(self, in_nc: int = 32, out_nc: int = 64, nf: int = 64,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__(nf, num_heads, dtype)
        self.project_out_1 = Conv2d(nf, nf, 1, dtype=dtype)
        self.project_out_3 = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)
        self.project_out_5 = Conv2d(nf, nf, 5, 1, 2, dtype=dtype)
        self.out_conv = nn.Sequential(Conv2d(nf, nf, 3, 1, 1, dtype=dtype))
        self.d_SKConv = DeformableSKConv(nf, out_nc, in_nc, dtype=dtype)

    def forward(self, inputs, extra_feat, pred_feat, mv):
        out = self.msa(flow_warp(extra_feat, mv), extra_feat, pred_feat)
        init1 = self.project_out_1(out)
        out = lrelu(self.out_conv(self.project_out_3(out)))
        return self.d_SKConv(out, init1, mv)
