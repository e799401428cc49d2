"""EGLA's ablations and variants, and CVSR_V7's residual-guided attention
block (counterparts of ``cdfo_tpu/models/attention_variants.py``), NHWC.

* ``EGLAwoLA``: long-range row/column attention only (CVSR_V8_woLA);
* ``EGLAwoGA``: 8x8 window attention only (CVSR_V8_woGA);
* ``EGLA1``: CVSR_V9's EGLA, a full-resolution sigmoid mask and the row and
  column 9-tap convs swapped;
* ``RDAB``: CVSR_V7's spatial-compensate block, a gumbel channel mask and a
  spatial-attention mask gating a 1x1-conv feature branch.

``cdfo_tpu`` computes their row, column and window attention as plain
einsums (no TPU kernel), and so does the port: a score product in the
operands' dtype, its softmax in float32, the probabilities rounded to the
features' dtype, then the product with v (in float32 where ``cdfo_tpu``'s
type promotion takes it there).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_egla import unwindows, windows
from .attention import _Direct9, _conv9_along
from .layers import Conv2d, lrelu


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
        if self.mask_mode == "expected":
            return torch.softmax(v, dim=-1)
        if u is None:
            if generator is None:
                raise ValueError(
                    "mask_mode='sample' draws gumbel noise: give RDAB a "
                    "torch.Generator on the model's device, or the uniform "
                    "draw u")
            u = torch.rand(shape, generator=generator, device=res.device)
            u.clamp_min_(torch.finfo(torch.float32).tiny)
        elif tuple(u.shape) != tuple(shape):
            raise ValueError(f"gumbel u of shape {tuple(u.shape)}, the "
                             f"features' is {tuple(shape)}")
        g = -torch.log(-torch.log(u.to(res.device, torch.float32)))
        return torch.softmax(v + g, dim=-1)

    def forward(self, res, x_c, generator=None, u=None):
        r_m = self.channel_mask(res, x_c.shape, generator, u).to(x_c.dtype)
        pooled = torch.cat([x_c.amax(dim=-1, keepdim=True),
                            x_c.mean(dim=-1, keepdim=True)], dim=-1)
        att_m = torch.sigmoid(self.spatial(pooled))
        out = self.conv_dc(x_c) * (r_m + att_m)
        return lrelu(self.conv_df(out))
