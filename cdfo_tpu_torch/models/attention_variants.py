"""EGLA's ablations and variants, and CVSR_V7's residual-guided attention
block (counterparts of ``cdfo_tpu/models/attention_variants.py``), NHWC.

* ``EGLAwoLA``: long-range row/column attention only (CVSR_V8_woLA);
* ``EGLAwoGA``: 8x8 window attention only (CVSR_V8_woGA);
* ``EGLA1``: CVSR_V9's EGLA, a full-resolution sigmoid mask and the row and
  column 9-tap convs swapped;
* ``RDAB``: CVSR_V7's spatial-compensate block, a gumbel channel mask and a
  spatial-attention mask gating a 1x1-conv feature branch.
* the library members no registry model builds: the residual-guided blocks
  ``RDABS`` (gumbel mask), ``RDABUnderscore`` and ``RPAB``; the attention
  modules ``PAM``, ``CAMSelf``, ``CAM``, ``NonLocalAttention``,
  ``RSNLAttention`` (gumbel mask), ``CrissCrossAttention``, ``SKFF`` and
  ``ContextBlock``; ``RCAB``; and the 3-D residual blocks
  ``CalibResBlock3D`` and ``ResBlock3D`` (``Conv3d`` over a depth axis
  made of channels or of a patch grid).

``cdfo_tpu`` computes their row, column and window attention as plain
einsums (no TPU kernel), and so does the port: a score product in the
operands' dtype, its softmax in float32, the probabilities rounded to the
features' dtype, then the product with v (in float32 where ``cdfo_tpu``'s
type promotion takes it there).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_egla import unwindows, windows
from ..ops.resize import interpolate_bilinear
from .attention import _Direct9, _conv9_along
from .layers import CALayer, Conv2d, _fill_uniform, lrelu


def _attend(q, v, dt):
    """softmax(q q^T) v over the last two dims: the score product in q's
    dtype, softmax in float32 rounded to ``dt``, the product in the wider
    of ``dt`` and v's dtype (JAX's promotion)."""
    p = torch.softmax(torch.matmul(q, q.transpose(-1, -2)).float(), dim=-1)
    out_dt = torch.promote_types(dt, v.dtype)
    return torch.matmul(p.to(dt).to(out_dt), v.to(out_dt))


def _rows_to_columns(t, b):
    """(b h) w c -> (b w) h c."""
    bh, w, c = t.shape
    return t.reshape(b, bh // b, w, c).transpose(1, 2).reshape(b * w, -1, c)


def _columns_to_image(t, b):
    """(b w) h c -> b h w c."""
    bw, h, c = t.shape
    return t.reshape(b, bw // b, h, c).transpose(1, 2)


class EGLAwoLA(nn.Module):
    """LLongRangAttention_woLA (`:2255-2324`): long-range row/column
    attention only, no residual mask, no window branch. The row query is
    the full 2C-channel projection (the reference's rearrange keeps both
    halves); v is its C-channel second half. forward(x)."""

    def __init__(self, in_dim: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_conv = Conv2d(in_dim, in_dim * 2, 1, dtype=dtype)
        self.directW1_conv = _Direct9((1, 9))
        self.directH1_conv = _Direct9((9, 1))

    def forward(self, x):
        b, h, w, c = x.shape
        x_ = self.input_conv(x)
        w1_k, w1_b = self.directW1_conv.taps()
        h1_k, h1_b = self.directH1_conv.taps()
        sparse_q = _conv9_along(x_.reshape(b * h, w, 2 * c), w1_k, w1_b, 2)
        v_r = _conv9_along(x_[..., c:].reshape(b * h, w, c), w1_k, w1_b, 2)
        v_r = _attend(sparse_q, v_r, x.dtype)
        q_c = _conv9_along(_rows_to_columns(sparse_q, b), h1_k, h1_b, 1)
        long_out = _attend(q_c, _rows_to_columns(v_r, b), x.dtype)
        return _columns_to_image(long_out, b) + x


class EGLAwoGA(nn.Module):
    """LLongRangAttention_woGA (`:2330-2456`): 8x8 window attention only,
    unmasked. forward(res, x, generator, u) keeps EGLA's signature; only
    ``x`` is read."""

    def __init__(self, in_dim: int = 64, window_size: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.input_conv = Conv2d(in_dim, in_dim * 2, 1, dtype=dtype)

    def forward(self, res, x, generator=None, u=None):
        b, h, w, c = x.shape
        ws = self.window_size
        q_full, v_full = self.input_conv(x).chunk(2, dim=-1)
        loc = _attend(windows(q_full, ws), windows(v_full, ws), x.dtype)
        return unwindows(loc, b, h, w, ws) + x


class EGLA1(nn.Module):
    """LLongRangAttention_1 (`:2463-2574`), CVSR_V9's RDAB slot: a
    full-resolution sigmoid mask (three 3x3 convs, no pooling) thresholded
    at 0.5; the row conv ``directW_conv`` is (9, 1) along positions and the
    column conv ``directH_conv`` (1, 9) along channels, the swap of EGLA's;
    the row v is not convolved. forward(res, x, generator, u) keeps EGLA's
    signature; the mask is thresholded, so it reads no noise."""

    def __init__(self, in_dim: int = 64, window_size: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.conv_du_re = nn.Sequential(
            Conv2d(in_dim, in_dim, 3, 1, 1, dtype=dtype), nn.ReLU(),
            Conv2d(in_dim, in_dim, 3, 1, 1, dtype=dtype), nn.ReLU(),
            Conv2d(in_dim, in_dim, 3, 1, 1, dtype=dtype))
        self.input_conv = Conv2d(in_dim, in_dim * 2, 1, dtype=dtype)
        self.directW_conv = _Direct9((9, 1))
        self.directH_conv = _Direct9((1, 9))
        self.fuse = Conv2d(in_dim * 2, in_dim, 1, dtype=dtype)

    def forward(self, res, x, generator=None, u=None):
        b, h, w, c = x.shape
        dt = x.dtype
        with torch.no_grad():   # the threshold carries no gradient
            rm = torch.sigmoid(self.conv_du_re(res).float())
            res_mask = (rm >= 0.5).to(dt)
        q_full, v_full = self.input_conv(x).chunk(2, dim=-1)
        w_k, w_b = self.directW_conv.taps()
        h_k, h_b = self.directH_conv.taps()
        # rows: directW along the positions (w), then attention along w
        sparse_q = _conv9_along((res_mask * q_full).reshape(b * h, w, c),
                                w_k, w_b, 1)
        v_r = _attend(sparse_q, v_full.reshape(b * h, w, c), dt)
        # columns: directH along the channels, then attention along h
        q_c = _conv9_along(_rows_to_columns(sparse_q, b), h_k, h_b, 2)
        long_out = _columns_to_image(
            _attend(q_c, _rows_to_columns(v_r, b), dt), b)
        ws = self.window_size
        q_w = windows((1.0 - res_mask) * q_full, ws)
        loc = unwindows(_attend(q_w, windows(v_full, ws), dt), b, h, w, ws)
        return self.fuse(torch.cat([long_out, loc], dim=-1)) + x


def _channel_softmax(v, mask_mode, generator, u, who):
    """The softmax over channels of float32 ``v`` (b, h, w, c): noise-free
    under ``mask_mode="expected"``, else of ``v + g`` with gumbel noise
    ``g = -log(-log(u))`` per element, ``u`` uniform in [tiny, 1) drawn from
    ``generator`` or given (``cdfo_tpu``'s ``_sample_mask``)."""
    if mask_mode == "expected":
        return torch.softmax(v, dim=-1)
    shape = tuple(v.shape)
    if u is None:
        if generator is None:
            raise ValueError(
                f"mask_mode='sample' draws gumbel noise: give {who} a "
                "torch.Generator on the model's device, or the uniform draw u")
        u = torch.rand(shape, generator=generator, device=v.device)
        u.clamp_min_(torch.finfo(torch.float32).tiny)
    elif tuple(u.shape) != shape:
        raise ValueError(f"gumbel u of shape {tuple(u.shape)}, the mask's "
                         f"is {shape}")
    g = -torch.log(-torch.log(u.to(v.device, torch.float32)))
    return torch.softmax(v + g, dim=-1)


class RDAB(nn.Module):
    """Residual-map-guided attention block (`:2795-2846`), CVSR_V7's
    spatial-compensate module: a channel mask (the softmax over channels of
    a squeezed residual feature; under ``mask_mode="sample"`` with gumbel
    noise per pixel, ``softmax(v + g)``, not thresholded) plus a
    spatial-attention mask, gating a 1x1-conv feature branch.
    forward(res, x_c, generator=None, u=None): the noise from
    ``generator`` or as the uniform draw ``u`` (b, h, w, c), as
    ``EGLA.sampled_mask`` takes it."""

    def __init__(self, channel: int = 64, mask_mode: str = "expected",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_mode = mask_mode
        self.conv_du_re = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype), nn.ReLU(),
            Conv2d(channel, channel, 3, 2, 2, dtype=dtype), nn.ReLU())
        self.conv_du_re2 = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype), nn.ReLU())
        self.spatial = Conv2d(2, 1, 3, 1, 1, dtype=dtype)
        self.conv_dc = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype), nn.LeakyReLU(0.1),
            Conv2d(channel, channel, 1, dtype=dtype))
        self.conv_df = nn.Sequential(Conv2d(channel, channel, 1, dtype=dtype))

    def channel_mask(self, res, shape, generator=None, u=None):
        """(b, h, w, c) float32 soft channel mask of ``shape``."""
        v = self.conv_du_re(res).mean(dim=(1, 2), keepdim=True)
        v = self.conv_du_re2(v).float().expand(shape)
        return _channel_softmax(v, self.mask_mode, generator, u, "RDAB")

    def forward(self, res, x_c, generator=None, u=None):
        r_m = self.channel_mask(res, x_c.shape, generator, u).to(x_c.dtype)
        pooled = torch.cat([x_c.amax(dim=-1, keepdim=True),
                            x_c.mean(dim=-1, keepdim=True)], dim=-1)
        att_m = torch.sigmoid(self.spatial(pooled))
        out = self.conv_dc(x_c) * (r_m + att_m)
        return lrelu(self.conv_df(out))


def _max_pool3(x):
    """3x3 max pool, stride 1, no padding (NHWC): H and W shrink by 2."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 1).permute(0, 2, 3, 1)


def _residual_squeeze(channel: int, dtype) -> nn.Sequential:
    """``conv_du_re``: 1x1 conv, relu, 3x3 stride-2 pad-2 conv, relu."""
    return nn.Sequential(
        Conv2d(channel, channel, 1, dtype=dtype), nn.ReLU(),
        Conv2d(channel, channel, 3, 2, 2, dtype=dtype), nn.ReLU())


def _pooled_mask_logits(module, res, size):
    """The max-pooled residual squeeze through ``conv_du_re2``, resized
    (bilinear) to ``size``: float32 mask logits (b, h, w, c)."""
    v = module.conv_du_re2(_max_pool3(module.conv_du_re(res)))
    return interpolate_bilinear(v, size=size).float()


def _prelu(t, a):
    return torch.where(t >= 0, t, a * t)


def _flat_softmax(scores, dt):
    """softmax over the last axis in float32, rounded to ``dt``."""
    return torch.softmax(scores.float(), dim=-1).to(dt)


class RDABS(nn.Module):
    """RDAB_S (`:2734-2790`): the residual squeeze max-pooled (3x3, stride
    1, unpadded, so it shrinks by 2 before the bilinear resize back) gives
    a channel mask (gumbel-sampled under ``mask_mode="sample"``), and a
    CALayer-style gate of ``x_c`` a second one; their sum gates a 1x1-conv
    feature branch. forward(res, x_c, generator=None, u=None): the noise
    as ``RDAB`` takes it, ``u`` of ``res``'s (b, h, w) and c."""

    def __init__(self, channel: int = 64, reduction: int = 16,
                 mask_mode: str = "expected",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_mode = mask_mode
        self.conv_du_re = _residual_squeeze(channel, dtype)
        self.conv_du_re2 = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype), nn.ReLU())
        self.conv_du_am = nn.Sequential(
            Conv2d(channel, channel // reduction, 1, dtype=dtype), nn.ReLU(),
            Conv2d(channel // reduction, channel, 1, dtype=dtype))
        self.conv_dc = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype), nn.LeakyReLU(0.1),
            Conv2d(channel, channel, 1, dtype=dtype))
        self.conv_df = nn.Sequential(Conv2d(channel, channel, 1, dtype=dtype))

    def forward(self, res, x_c, generator=None, u=None):
        v = _pooled_mask_logits(self, res, tuple(res.shape[1:3]))
        r_m = _channel_softmax(v, self.mask_mode, generator, u,
                               "RDABS").to(x_c.dtype)
        att_m = torch.sigmoid(self.conv_du_am(
            x_c.mean(dim=(1, 2), keepdim=True)))
        out = self.conv_dc(x_c) * (r_m + att_m)
        return lrelu(self.conv_df(out))


class RDABUnderscore(nn.Module):
    """RDAB_ (`:2852-2883`): a squeeze-excite gate of the residual scales an
    expanded (4x) feature branch of ``x_c``; that plus ``x``, concatenated
    with ``x``, through a 1x1 conv and relu. forward(res, x, x_c)."""

    def __init__(self, channel: int = 64, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv2d(channel, channel // reduction, 1, dtype=dtype), nn.ReLU(),
            Conv2d(channel // reduction, channel, 1, dtype=dtype),
            nn.Sigmoid())
        self.conv_dc = nn.Sequential(
            Conv2d(channel, channel * 4, 1, dtype=dtype), nn.ReLU(),
            Conv2d(channel * 4, channel, 1, dtype=dtype), nn.ReLU())
        self.conv_df = nn.Sequential(
            Conv2d(2 * channel, channel, 1, dtype=dtype))

    def forward(self, res, x, x_c):
        y = self.conv_du(res.mean(dim=(1, 2), keepdim=True))
        out = self.conv_dc(x_c) * y + x
        return torch.relu(self.conv_df(torch.cat([out, x], dim=-1)))


class PAM(nn.Module):
    """Position attention, SAGAN-style (`:1902-1935`), across two inputs:
    queries from ``x1``, keys and values from ``x2``, the result scaled by
    ``gamma`` (zero at init) and added to ``x2``. forward(x1, x2)."""

    def __init__(self, in_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        self.query_conv = Conv2d(in_dim, in_dim // 8, 1, dtype=dtype)
        self.key_conv = Conv2d(in_dim, in_dim // 8, 1, dtype=dtype)
        self.value_conv = Conv2d(in_dim, in_dim, 1, dtype=dtype)

    def forward(self, x1, x2):
        b, h, w, c = x1.shape
        q = self.query_conv(x1).reshape(b, h * w, -1)
        k = self.key_conv(x2).reshape(b, h * w, -1)
        v = self.value_conv(x2).reshape(b, h * w, -1)
        attn = _flat_softmax(torch.matmul(q, k.transpose(1, 2)), x1.dtype)
        out = torch.matmul(attn, v).reshape(b, h, w, c)
        return self.gamma * out + x2


class RPAB(nn.Module):
    """Residual-guided position attention block (`:2888-2920`):
    ``PAM(res, x)`` concatenated with ``x_c``, a 1x1 conv, relu (the
    reference's ``conv_du`` / ``conv_dc`` are never called and have no
    parameters here, as in ``cdfo_tpu``). forward(res, x, x_c)."""

    def __init__(self, channel: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.PAM = PAM(channel, dtype=dtype)
        self.conv_df = nn.Sequential(
            Conv2d(2 * channel, channel, 1, dtype=dtype))

    def forward(self, res, x, x_c):
        y = self.PAM(res, x)
        return torch.relu(self.conv_df(torch.cat([y, x_c], dim=-1)))


def _channel_energy_attention(q, k, dt):
    """CAM's attention: energy = q^T k over pixels (c, c) in float32, its
    row max minus it, softmax, applied to k's channels."""
    b, h, w, c = k.shape
    qf, kf = q.reshape(b, h * w, c), k.reshape(b, h * w, c)
    energy = torch.matmul(qf.transpose(1, 2), kf).float()
    energy = energy.amax(dim=-1, keepdim=True) - energy
    attn = torch.softmax(energy, dim=-1).to(dt)
    return torch.matmul(kf, attn.transpose(1, 2)).reshape(b, h, w, c)


class CAMSelf(nn.Module):
    """CAM_ (`:1939-1968`): channel self-attention on the max-subtracted
    energy, scaled by ``gamma`` (zero at init), plus ``x``."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.gamma * _channel_energy_attention(x, x, x.dtype) + x


class CAM(nn.Module):
    """CAM (`:1972-2000`): channel attention with queries from ``x0 + x2``
    and keys and values from ``x2``. forward(x0, x1, x2); ``x1`` gives only
    the shape and dtype, as in the reference."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x0, x1, x2):
        return self.gamma * _channel_energy_attention(x0 + x2, x2,
                                                      x1.dtype) + x2


class RCAB(nn.Module):
    """Residual channel attention block (`:2005-2023`): conv, relu, conv,
    conv, CALayer (whose two 1x1 convs are full width: the reference
    ignores ``reduction``), plus the input."""

    def __init__(self, n_feat: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(n_feat, n_feat, 3, 1, 1, dtype=dtype), nn.ReLU(),
            Conv2d(n_feat, n_feat, 3, 1, 1, dtype=dtype),
            Conv2d(n_feat, n_feat, 3, 1, 1, dtype=dtype),
            CALayer(n_feat, dtype=dtype))

    def forward(self, x):
        return self.body(x) + x


class NonLocalAttention(nn.Module):
    """Embedded-gaussian non-local block (`:2047-2069`) with PReLU embeds
    (one slope each: ``m1_alpha``, ``m2_alpha``, ``as_alpha``). Its score
    matrix is (H W)^2 per image."""

    def __init__(self, channel: int = 128, reduction: int = 2,
                 res_scale: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res_scale = res_scale
        for name in ("m1_alpha", "m2_alpha", "as_alpha"):
            self.register_parameter(name, nn.Parameter(torch.full((1,),
                                                                  0.25)))
        self.conv_match1 = nn.Sequential(
            Conv2d(channel, channel // reduction, 1, dtype=dtype))
        self.conv_match2 = nn.Sequential(
            Conv2d(channel, channel // reduction, 1, dtype=dtype))
        self.conv_assembly = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype))

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            for a in (self.m1_alpha, self.m2_alpha, self.as_alpha):
                a.fill_(0.25)

    def forward(self, x):
        b, h, w, c = x.shape
        e1 = _prelu(self.conv_match1(x), self.m1_alpha).reshape(b, h * w, -1)
        e2 = _prelu(self.conv_match2(x), self.m2_alpha).reshape(b, h * w, -1)
        asm = _prelu(self.conv_assembly(x), self.as_alpha)
        score = _flat_softmax(torch.matmul(e1, e2.transpose(1, 2)), x.dtype)
        out = torch.matmul(score, asm.reshape(b, h * w, -1))
        return out.reshape(b, h, w, c) + self.res_scale * x


class RSNLAttention(nn.Module):
    """Residual-sparse non-local attention (`:2663-2716`): the key
    embedding is the residual's channel mask itself (RDABS's, gumbel-
    sampled under ``mask_mode="sample"``). forward(res, x_com,
    generator=None, u=None), ``u`` of ``x_com``'s shape."""

    def __init__(self, channel: int = 64, res_scale: float = 1.0,
                 mask_mode: str = "expected",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_mode, self.res_scale = mask_mode, res_scale
        self.conv_du_re = _residual_squeeze(channel, dtype)
        self.conv_du_re2 = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype), nn.ReLU())
        self.m1_alpha = nn.Parameter(torch.full((1,), 0.25))
        self.as_alpha = nn.Parameter(torch.full((1,), 0.25))
        self.conv_match1 = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype))
        self.conv_assembly = nn.Sequential(
            Conv2d(channel, channel, 1, dtype=dtype))

    def init_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.m1_alpha.fill_(0.25)
            self.as_alpha.fill_(0.25)

    def forward(self, res, x_com, generator=None, u=None):
        b, h, w, c = x_com.shape
        v = _pooled_mask_logits(self, res, (h, w))
        r_m = _channel_softmax(v, self.mask_mode, generator, u,
                               "RSNLAttention").to(x_com.dtype)
        e1 = _prelu(self.conv_match1(x_com), self.m1_alpha)
        asm = _prelu(self.conv_assembly(x_com), self.as_alpha)
        score = _flat_softmax(torch.matmul(
            e1.reshape(b, h * w, c), r_m.reshape(b, h * w, c).transpose(1, 2)),
            x_com.dtype)
        out = torch.matmul(score, asm.reshape(b, h * w, c))
        return out.reshape(b, h, w, c) + self.res_scale * x_com


class CrissCrossAttention(nn.Module):
    """Criss-cross attention (`:2078-2117`): each pixel attends over its
    column (its own position masked with -inf, the reference's ``INF``
    helper) and its row in one softmax; the keys read ``x`` where the
    residual is non-zero. ``gamma`` (zero at init) scales the result.
    forward(res, x)."""

    def __init__(self, in_dim: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        self.query_conv = Conv2d(in_dim, in_dim // 8, 1, dtype=dtype)
        self.key_conv = Conv2d(in_dim, in_dim // 8, 1, dtype=dtype)
        self.value_conv = Conv2d(in_dim, in_dim, 1, dtype=dtype)

    def forward(self, res, x):
        b, h, w, c = x.shape
        q = self.query_conv(x)
        k = self.key_conv((res != 0).to(x.dtype) * x)
        v = self.value_conv(x)
        eh = torch.einsum("bhwc,bgwc->bhwg", q, k).float()
        diag = torch.eye(h, dtype=torch.bool, device=x.device)[:, None, :]
        eh = eh.masked_fill(diag, float("-inf"))
        ew = torch.einsum("bhwc,bhvc->bhwv", q, k).float()
        att = torch.softmax(torch.cat([eh, ew], dim=-1), dim=-1).to(x.dtype)
        out_h = torch.einsum("bhwg,bgwc->bhwc", att[..., :h], v)
        out_w = torch.einsum("bhwv,bhvc->bhwc", att[..., h:], v)
        return self.gamma * (out_h + out_w) + x


class SKFF(nn.Module):
    """Selective kernel feature fusion (`:2925-2960`) of two branches: a
    GAP squeeze (bias-free 1x1 conv, lrelu 0.2), a bias-free 1x1 conv per
    branch (``fcs``), softmax over the branches. forward(feat1, feat2)."""

    def __init__(self, in_channels: int, height: int = 2, reduction: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = max(int(in_channels / reduction), 4)
        self.conv_du = nn.Sequential(
            Conv2d(in_channels, d, 1, bias=False, dtype=dtype),
            nn.LeakyReLU(0.2))
        self.fcs = nn.ModuleList(
            [Conv2d(d, in_channels, 1, bias=False, dtype=dtype)
             for _ in range(height)])

    def forward(self, feat1, feat2):
        feats = torch.stack([feat1, feat2], dim=1)     # (b, 2, h, w, c)
        z = self.conv_du(feats.sum(dim=1).mean(dim=(1, 2), keepdim=True))
        att = torch.softmax(torch.stack([fc(z) for fc in self.fcs], dim=1),
                            dim=1)
        return (feats * att).sum(dim=1)


class ContextBlock(nn.Module):
    """Global-context block (`:3013-3064`): a softmax over pixels of a
    bias-free 1x1 conv pools ``x`` to a context vector, which two bias-free
    1x1 convs (lrelu 0.2 between) add back to every pixel."""

    def __init__(self, n_feat: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_mask = Conv2d(n_feat, 1, 1, bias=False, dtype=dtype)
        self.channel_add_conv = nn.Sequential(
            Conv2d(n_feat, n_feat, 1, bias=False, dtype=dtype),
            nn.LeakyReLU(0.2),
            Conv2d(n_feat, n_feat, 1, bias=False, dtype=dtype))

    def forward(self, x):
        b, h, w, c = x.shape
        m = torch.softmax(self.conv_mask(x).reshape(b, h * w, 1).float(),
                          dim=1).to(x.dtype)
        ctx = torch.matmul(m.transpose(1, 2), x.reshape(b, h * w, c))
        return x + self.channel_add_conv(ctx.reshape(b, 1, 1, c))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` (NCDHW, weight (out, in, kd, kh, kw)), 3x3x3 with
    padding 1, its weights drawn from the generator as torch's default
    init draws them."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 3, padding=1, dtype=dtype)

    def init_parameters(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _fill_uniform(self.weight, bound, generator)
        _fill_uniform(self.bias, bound, generator)


class CalibResBlock3D(nn.Module):
    """Calib_ResBlock_3d (`:2985-3009`): the map cut into a 4 x 4 grid of
    cells; a volume of 4 channels (the grid's rows) over depth = the
    grid's columns, height = C and width = a cell's pixels goes through a
    residual Conv3d(4 -> nf -> 4) and is scattered back and added to the
    input. H and W must be multiples of 4."""

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dcn0 = Conv3d(4, nf, dtype=dtype)
        self.dcn1 = Conv3d(nf, 4, dtype=dtype)

    def forward(self, x):
        b, h, w, c = x.shape
        p, hh, ww = 4, h // 4, w // 4
        # (b, h1, w2, c, cell pixels): NCDHW with channels = grid rows
        v = x.permute(0, 3, 1, 2).reshape(b, c, hh, p, ww, p) \
            .permute(0, 3, 5, 1, 2, 4).reshape(b, p, p, c, hh * ww)
        y = self.dcn1(lrelu(self.dcn0(v.to(self.dcn0.weight.dtype)))) + v
        out = y.reshape(b, p, p, c, hh, ww).permute(0, 3, 4, 1, 5, 2)
        return out.reshape(b, c, h, w).permute(0, 2, 3, 1) + x


class ResBlock3D(nn.Module):
    """ResBlock_3d (`:2964-2981`): a residual Conv3d(1 -> nf -> 1) over a
    volume whose depth axis is the channels."""

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dcn0 = Conv3d(1, nf, dtype=dtype)
        self.dcn1 = Conv3d(nf, 1, dtype=dtype)

    def forward(self, x):
        v = x.permute(0, 3, 1, 2)[:, None]              # (b, 1, c, h, w)
        y = self.dcn1(lrelu(self.dcn0(v.to(self.dcn0.weight.dtype)))) + v
        return y[:, 0].permute(0, 2, 3, 1)
