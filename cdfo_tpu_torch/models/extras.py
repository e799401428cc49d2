"""The rest of the reference's module library (counterparts of
``cdfo_tpu/models/extras.py``), NHWC; no registry model builds them:

* the alternative trunks ``AGGSCGroup`` / ``AGGSCNet`` (on the pyramid
  trunk's blocks) and ``RiRGroup`` / ``RinRNet``;
* ``FGSWMSA``, flow-guided window MSA;
* ``lower_bound`` (an autograd Function with the reference's gradient),
  ``GDN`` and the MV autoencoder ``EMVNet``;
* ``LocalCorr`` and ``MotionFeaFusion`` (temporal correlation);
* ``ConvUnit``, ``GhostModuleMul`` and ``DSTA`` (deformable
  spatio-temporal attention, on the plain ``deform_conv2d``).

Parameters carry ``cdfo_tpu``'s converter names; raw leaves (``GDN``'s
``beta`` / ``gamma``, ``DSTA``'s ``dcn_weight`` / ``dcn_bias``) keep their
own names, and ``gamma`` is stored as the reference's 1x1 conv weight
(out, in), the transpose of ``cdfo_tpu``'s (see ``GDN``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import deform_conv2d
from ..ops.resize import interpolate_bilinear
from ..ops.warp import flow_warp_nearest
from .dcn import _ref_weight_init
from .layers import Conv2d, ConvTranspose2d, lrelu
from .trunk import BlockPyr, SCGroupPyr


class AGGSCGroup(nn.Module):
    """The AGG trunk group (`:528-546`): ``back_rbs`` pyramid blocks (the
    reference's AGGBlock computes the pyramid Block), then each level plus
    the shared 3x3 conv of its result. forward(x_list) -> list."""

    def __init__(self, nf: int = 64, back_rbs: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.ModuleList(
            [BlockPyr(nf, dtype=dtype) for _ in range(back_rbs)])
        self.conv = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, x_list):
        r = list(x_list)
        for block in self.body:
            r = block(r)
        return [x + self.conv(t) for x, t in zip(x_list, r)]


class AGGSCNet(nn.Module):
    """`:550-565`: ``num_groups`` plain pyramid groups (the reference
    stacks SCGroups here, not AGG groups), then the input added level by
    level. forward(x_list) -> list."""

    def __init__(self, nf: int = 64, num_groups: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.ModuleList(
            [SCGroupPyr(nf, dtype=dtype) for _ in range(num_groups)])

    def forward(self, x_list):
        r = tuple(x_list)
        for group in self.body:
            r = group(*r)
        return [x + t for x, t in zip(x_list, r)]


class RiRGroup(nn.Module):
    """Residual-in-residual group (`:569-587`): ``back_rbs`` times (conv
    nf -> 4 nf, lrelu, conv 4 nf -> nf, lrelu), a 3x3 conv, plus the
    input."""

    def __init__(self, nf: int = 64, back_rbs: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        for _ in range(back_rbs):
            layers += [Conv2d(nf, nf * 4, 3, 1, 1, dtype=dtype),
                       nn.LeakyReLU(0.1),
                       Conv2d(nf * 4, nf, 3, 1, 1, dtype=dtype),
                       nn.LeakyReLU(0.1)]
        self.body = nn.Sequential(*layers)
        self.conv = Conv2d(nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        return x + self.conv(self.body(x))


class RinRNet(nn.Module):
    """`:591-604`: ``num_groups`` RiR groups plus the input."""

    def __init__(self, nf: int = 64, num_groups: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.Sequential(
            *[RiRGroup(nf, dtype=dtype) for _ in range(num_groups)])

    def forward(self, x):
        return x + self.body(x)


class FGSWMSA(nn.Module):
    """Flow-guided sparse window MSA (`:3740-3825`): the two neighbour
    frames resampled (nearest) along the flow give the keys and values of
    every 8x8 window of queries, 2 x 64 key tokens a window, ``heads``
    heads of ``dim_head``; LayerNorms (eps 1e-6, flax's) before the 3x3
    bias-free projections. forward(q_inp, k_f, k_r, flow); ``flow`` may be
    None. H and W must be multiples of the window."""

    def __init__(self, dim: int = 64, window_size: tuple = (3, 8, 8),
                 dim_head: int = 32, heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.heads = tuple(window_size), heads
        self.dim, self.dim_head = dim, dim_head
        inner = dim_head * heads
        self.norm_q = nn.LayerNorm(dim, eps=1e-6)
        self.norm_kv = nn.LayerNorm(dim, eps=1e-6)
        self.to_q = Conv2d(dim, inner, 3, 1, 1, bias=False, dtype=dtype)
        self.to_kv = Conv2d(dim, inner * 2, 3, 1, 1, bias=False, dtype=dtype)
        self.to_out = Conv2d(inner, dim, 3, 1, 1, bias=False, dtype=dtype)

    def init_parameters(self, generator: torch.Generator):
        for norm in (self.norm_q, self.norm_kv):
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def _norm(self, norm, t):
        return norm(t.float()).to(t.dtype)

    def forward(self, q_inp, k_f, k_r, flow):
        b, h, w, _ = q_inp.shape
        _, hb, wb = self.window_size
        inner = self.dim_head * self.heads
        if flow is not None:
            k_f = flow_warp_nearest(k_f, flow)
            k_r = flow_warp_nearest(k_r, flow)
        q = self.to_q(self._norm(self.norm_q, q_inp))
        kv_f = self.to_kv(self._norm(self.norm_kv, k_f))
        kv_r = self.to_kv(self._norm(self.norm_kv, k_r))
        k = torch.stack([kv_f[..., :inner], kv_r[..., :inner]], dim=1)
        v = torch.stack([kv_f[..., inner:], kv_r[..., inner:]], dim=1)

        def window(t):   # (b, f, h, w, c) -> (b nh nw, heads, f hb wb, d)
            f = t.shape[1]
            t = t.reshape(b, f, h // hb, hb, w // wb, wb, self.heads,
                          self.dim_head)
            return t.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(
                -1, self.heads, f * hb * wb, self.dim_head)

        qw, kw, vw = window(q[:, None]), window(k), window(v)
        sim = torch.matmul(qw * self.dim_head ** -0.5, kw.transpose(-1, -2))
        attn = torch.softmax(sim.float(), dim=-1).to(vw.dtype)
        out = torch.matmul(attn, vw)      # (b nh nw, heads, hb wb, d)
        out = out.reshape(b, h // hb, w // wb, self.heads, hb, wb,
                          self.dim_head).permute(0, 1, 4, 2, 5, 3, 6)
        return self.to_out(out.reshape(b, h, w, inner))


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        passthrough = (x >= ctx.bound) | (g < 0)
        return torch.where(passthrough, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)`` with the reference's LowerBound gradient
    (`:3830-3844`, ``cdfo_tpu``'s ``jax.custom_vjp``): the gradient passes
    where ``x >= bound`` or where it is negative (it would push ``x`` up),
    and is zero elsewhere."""
    return _LowerBound.apply(x, float(bound))


class GDN(nn.Module):
    """Generalized divisive normalization (`:3848-3915`):
    ``y_i = x_i / sqrt(beta_i + sum_j gamma[i, j] x_j^2)`` (``x * sqrt(...)``
    with ``inverse``), ``beta`` and ``gamma`` reparametrised through
    ``lower_bound`` (squared, less a pedestal). ``gamma`` is stored as the
    reference's 1x1 conv weight (out i, in j); ``cdfo_tpu`` keeps its
    transpose (``einsum("bhwj,ji->bhwi")``) and ``from_flax`` transposes
    it."""

    def __init__(self, ch: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1,
                 reparam_offset: float = 2 ** -18,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ch, self.inverse, self.gamma_init = ch, inverse, gamma_init
        self.pedestal = reparam_offset ** 2
        self.beta_bound = (beta_min + self.pedestal) ** 0.5
        self.gamma_bound = reparam_offset
        self.beta = nn.Parameter(torch.empty(ch))
        self.gamma = nn.Parameter(torch.empty(ch, ch))
        self.init_parameters(None)

    def init_parameters(self, generator):
        with torch.no_grad():
            self.beta.copy_(torch.sqrt(torch.ones(self.ch) + self.pedestal))
            self.gamma.copy_(torch.sqrt(self.gamma_init * torch.eye(self.ch)
                                        + self.pedestal))

    def forward(self, x):
        beta = lower_bound(self.beta, self.beta_bound) ** 2 - self.pedestal
        gamma = lower_bound(self.gamma, self.gamma_bound) ** 2 \
            - self.pedestal
        norm = torch.sqrt(torch.matmul(x.square(), gamma.t().to(x.dtype))
                          + beta.to(x.dtype))
        return x * norm if self.inverse else x / norm


class EMVNet(nn.Module):
    """MV enhancement autoencoder (`:3974-4034`) as the reference's forward
    runs it: conv1 (stride 2) and gdn1, then deconv4; the middle layers are
    commented out there and have no parameters here, as in ``cdfo_tpu``.
    forward(flow (B, H, W, 2))."""

    def __init__(self, out_channel_n: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = out_channel_n
        self.conv1 = Conv2d(2, n, 3, 2, 2, dtype=dtype)
        self.gdn1 = GDN(n, dtype=dtype)
        self.deconv4 = ConvTranspose2d(n, 2, 3, 2, 2, 1, dtype=dtype)

    def forward(self, flow):
        return self.deconv4(self.gdn1(self.conv1(flow)))


def _l2_unit(t):
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True) \
        .clamp_min(1e-12)


class LocalCorr(nn.Module):
    """Temporal correlation aggregation (`:3919-3951`): each neighbour's
    reflect-padded ``nbr_size`` patch of unit vectors, softmax-weighted by
    its cosine with the reference feature, scaled by
    ``exp(alpha (nbr - mean)^2)``; the results and ``ref`` stacked on axis
    1. No parameters. forward(nbr_list, ref)."""

    def __init__(self, nf: int = 64, nbr_size: int = 3, alpha: float = -1.0):
        super().__init__()
        self.nbr_size, self.alpha = nbr_size, alpha

    def forward(self, nbr_list: Sequence[torch.Tensor], ref: torch.Tensor):
        k = self.nbr_size
        pad = k // 2
        mean = torch.stack(list(nbr_list), 1).mean(dim=1).detach()
        refn = _l2_unit(ref.detach())
        outs = []
        for nbr in nbr_list:
            wdiff = torch.exp(self.alpha * (nbr - mean).square())
            h, w = nbr.shape[1:3]
            npad = F.pad(nbr.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                         mode="reflect").permute(0, 2, 3, 1)
            patches = _l2_unit(torch.stack(
                [npad[:, dy:dy + h, dx:dx + w] for dy in range(k)
                 for dx in range(k)], dim=3))          # (b, h, w, k*k, c)
            d = torch.einsum("bhwc,bhwnc->bhwn", refn, patches)
            agg = torch.einsum("bhwn,bhwnc->bhwc", torch.softmax(d, dim=-1),
                               patches)
            outs.append(agg * wdiff)
        return torch.stack(outs + [ref], dim=1)


class MotionFeaFusion(nn.Module):
    """Gated fusion of two motion features (`:3955-3970`): a sigmoid
    weighting of their concatenation splits between ``m0`` and ``m1``,
    then a 3x3 conv and lrelu. forward(m0, m1)."""

    def __init__(self, nf: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scaleing = nn.Sequential(
            Conv2d(2 * nf, nf, 3, 1, 1, dtype=dtype))
        self.conv_out = Conv2d(2 * nf, nf, 3, 1, 1, dtype=dtype)

    def forward(self, m0, m1):
        wt = torch.sigmoid(self.scaleing(torch.cat([m0, m1], dim=-1)))
        return lrelu(self.conv_out(torch.cat([wt * m0, (1.0 - wt) * m1],
                                             dim=-1)))


class ConvUnit(nn.Module):
    """`:2121-2139`: a conv, then relu or lrelu(0.1) unless ``use_act`` is
    False."""

    def __init__(self, num_in: int, num_out: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 use_act: bool = True, act_type: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_act, self.act_type = use_act, act_type
        self.conv = Conv2d(num_in, num_out, kernel_size, stride, padding,
                           groups=groups, dtype=dtype)

    def forward(self, x):
        y = self.conv(x)
        if self.use_act:
            y = torch.relu(y) if self.act_type == "relu" else lrelu(y)
        return y


class GhostModuleMul(nn.Module):
    """Ghost conv gated by a sigmoid attention branch (`:4038-4083`): a
    conv, then depthwise (1, 5) and (5, 1) convs (``short_conv_*``) give
    the gate; the primary 3x3 conv and its cheap 3x3 continuation (each
    with lrelu) are concatenated and gated. The reference passes an
    invalid ``num_groups`` to ``nn.Conv2d`` (it would crash); ``groups``
    here, as in ``cdfo_tpu``. ``num_out`` must be even with ``ratio`` 2."""

    def __init__(self, num_in: int, num_out: int, kernel_size: int = 1,
                 ratio: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        init_ch = math.ceil(num_out / ratio)
        self.short_conv_0 = Conv2d(num_in, num_out, kernel_size, 1,
                                   kernel_size // 2, dtype=dtype)
        self.short_conv_1 = Conv2d(num_out, num_out, (1, 5), 1, (0, 2),
                                   groups=num_out, dtype=dtype)
        self.short_conv_2 = Conv2d(num_out, num_out, (5, 1), 1, (2, 0),
                                   groups=num_out, dtype=dtype)
        self.primary_conv_0 = Conv2d(num_in, init_ch, 3, 1, 1, dtype=dtype)
        self.cheap_operation_0 = Conv2d(init_ch, init_ch, 3, 1, 1,
                                        dtype=dtype)

    def forward(self, x):
        res = torch.sigmoid(self.short_conv_2(self.short_conv_1(
            self.short_conv_0(x))))
        x1 = lrelu(self.primary_conv_0(x))
        x2 = lrelu(self.cheap_operation_0(x1))
        return torch.cat([x1, x2], dim=-1) * res


def _max_pool(x, k, s):
    """k x k max pool of stride s, no padding (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


class DSTA(nn.Module):
    """Deformable spatio-temporal attention (`ops/attentionlayer.py:12-82`):
    a quarter-width saliency branch, max-pooled (7, stride 3), whose
    modulated DCN (one deformable group a channel; raw ``dcn_weight`` /
    ``dcn_bias``) takes offsets and masks from two heads (one at half
    resolution, resized up); its GAP gives a channel gate and its upsampled
    map a spatial one."""

    def __init__(self, n_feats: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = n_feats // 4
        self.f = f
        self.conv1 = Conv2d(n_feats, f, 1, dtype=dtype)
        self.conv2 = Conv2d(f, f, 3, 2, 0, dtype=dtype)
        self.conv_max = Conv2d(f, f, 3, 1, 1, dtype=dtype)
        self.conv3 = Conv2d(f, f, 3, 1, 1, dtype=dtype)
        self.conv3_ = Conv2d(f, f, 3, 1, 1, dtype=dtype)
        self.down_conv2_0 = Conv2d(f, f, 3, 2, 1, dtype=dtype)
        self.mask2 = Conv2d(f, f * 27, 3, 1, 1, dtype=dtype)
        self.mask = Conv2d(f, f * 27, 3, 1, 1, dtype=dtype)
        self.dcn_weight = nn.Parameter(torch.empty(f, f, 3, 3, dtype=dtype))
        self.dcn_bias = nn.Parameter(torch.zeros(f, dtype=dtype))
        self.conv_du = nn.Sequential(
            Conv2d(f, 2 * f, 1, dtype=dtype), nn.ReLU(),
            Conv2d(2 * f, n_feats, 1, dtype=dtype), nn.Sigmoid())
        self.conv_f = Conv2d(f, f, 1, dtype=dtype)
        self.conv4 = Conv2d(f, n_feats, 1, dtype=dtype)

    def init_parameters(self, generator: torch.Generator):
        _ref_weight_init(self.dcn_weight, self.f, generator)
        with torch.no_grad():
            self.dcn_bias.zero_()

    def forward(self, x):
        f = self.f
        c1_ = self.conv1(x)
        v_max = _max_pool(self.conv2(c1_), 7, 3)
        c3 = torch.relu(self.conv3(torch.relu(self.conv_max(v_max))))
        c3 = torch.relu(self.conv3_(c3))
        off_mask2 = self.mask2(torch.relu(self.down_conv2_0(c3)))
        off_msk = self.mask(c3)
        off_msk = off_msk + interpolate_bilinear(
            off_mask2, size=tuple(off_msk.shape[1:3]))
        c3 = torch.relu(deform_conv2d(
            v_max, off_msk[..., :f * 18], self.dcn_weight, self.dcn_bias,
            torch.sigmoid(off_msk[..., f * 18:]), padding=1))
        y = self.conv_du(c3.mean(dim=(1, 2), keepdim=True))
        c3 = interpolate_bilinear(c3, size=tuple(x.shape[1:3]))
        m = torch.sigmoid(self.conv4(c3 + self.conv_f(c1_)))
        return x * m * y
