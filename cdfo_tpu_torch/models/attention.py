"""Attention modules of CVSR_V8 (counterparts of
``cdfo_tpu/models/attention.py``), NHWC.

* ``MDTA``: multi-head transposed (channel) self-attention.
* ``EGLA``: residual-prior-guided long-range attention (a row then a column
  1-D self-attention, through the hand-written kernel on a GPU) plus an
  inverse-masked 8x8 window attention, with the noise-free ("expected")
  residual mask.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_attention import (column_self_attention,
                                   token_attention_plain,
                                   token_self_attention)
from .layers import Conv2d, _fill_normal


def _channel_attention(q, k, v, temperature, num_heads):
    """softmax((q^T k) / (|q| |k|) * temperature) applied to v, per head.

    q, k, v (b, h, w, c); channel index = head * ch + cc. The reference
    L2-normalises q and k over pixels before the gram product; the norms
    factor out of it, as in the JAX version. Grams and softmax in float32.
    """
    b, h, w, c = q.shape
    ch = c // num_heads

    def to_x(t):  # (b, h, w, c) -> (b, hw, head, ch)
        return t.reshape(b, h * w, num_heads, ch)

    qf = to_x(q).float()
    kf = to_x(k).float()
    v = to_x(v)
    nq = qf.square().sum(dim=1).sqrt().clamp_min(1e-12)   # (b, head, ch)
    nk = kf.square().sum(dim=1).sqrt().clamp_min(1e-12)
    g = torch.einsum("bxnc,bxnd->bncd", qf, kf)
    attn = g / (nq[..., :, None] * nk[..., None, :]) * temperature
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.einsum("bncd,bxnd->bxnc", attn, v)
    return out.reshape(b, h, w, c)


class MDTA(nn.Module):
    """Multi-DConv-Head Transposed Attention over channels (bias-free)."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv2d(dim, dim * 3, 1, bias=False, dtype=dtype)
        self.qkv_dwconv = Conv2d(dim * 3, dim * 3, 3, 1, 1, groups=dim * 3,
                                 bias=False, dtype=dtype)
        self.project_out = Conv2d(dim, dim, 1, bias=False, dtype=dtype)

    def forward(self, x):
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=-1)
        return self.project_out(
            _channel_attention(q, k, v, self.temperature, self.num_heads))


def _band_matrix(kernel, n):
    """(n, n) band matrix of a zero-padded 9-tap conv along an axis:
    M[s, d] = kernel[s - d + 4] for |s - d| <= 4."""
    i = torch.arange(n, device=kernel.device)
    o = i[:, None] - i[None, :]
    taps = kernel[(o + 4).clamp(0, 8)]
    return torch.where(o.abs() <= 4, taps, torch.zeros_like(taps))


def _conv9_along(x, kernel, bias, axis):
    """9-tap single-channel conv along one axis, zero padded, as one
    band-matrix contraction.

    ``directW1`` (kernel (1, 9) over the (w, c) plane) convolves along the
    *channel* axis (the last); ``directH1`` (kernel (9, 1) over the (h, c)
    plane) along H (axis 1 of (b, h, w, c)). The asymmetry is the
    reference's. The float32 bias promotes the result to float32, as the
    JAX version's does; EGLA's long-range attention therefore runs in
    float32 under a bfloat16 model.
    """
    n = x.shape[axis]
    m = _band_matrix(kernel, n).to(x.dtype)
    if axis == x.ndim - 1:
        out = torch.matmul(x, m)
    elif axis == 1 and x.ndim == 4:
        out = torch.einsum("bhwc,hg->bgwc", x, m)
    else:
        raise NotImplementedError(axis)
    return out.float() + bias


class _Direct9(nn.Module):
    """Params of the reference's 9-tap direct conv (``directW1_conv`` is
    a (1, 9) conv, ``directH1_conv`` a (9, 1) one); float32, normal(0.1)
    weight and zero bias as in the JAX init."""

    def __init__(self, kernel_size):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(1))

    def init_parameters(self, generator: torch.Generator):
        _fill_normal(self.weight, 0.1, generator)
        with torch.no_grad():
            self.bias.zero_()

    def taps(self):
        return self.weight.reshape(9), self.bias.reshape(())


def _windows(t, ws):
    """(b, h, w, c) -> (b * h/ws * w/ws, ws*ws, c)."""
    b, h, w, c = t.shape
    t = t.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def _unwindows(t, b, h, w, ws):
    c = t.shape[-1]
    t = t.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, c)


class EGLA(nn.Module):
    """LLongRangAttention with the expected residual mask:
    forward(res_prior, x) -> attended features + x."""

    def __init__(self, in_dim: int = 64, window_size: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dim = in_dim
        self.window_size = window_size
        self.conv_du_re = nn.Sequential(
            Conv2d(in_dim, in_dim, 1, dtype=dtype), nn.ReLU(),
            Conv2d(in_dim, in_dim, 3, 2, 2, dtype=dtype), nn.ReLU())
        self.conv_du_re2 = nn.Sequential(
            Conv2d(in_dim, in_dim, 1, dtype=dtype), nn.ReLU())
        self.input_conv = Conv2d(in_dim, in_dim * 2, 1, dtype=dtype)
        self.directW1_conv = _Direct9((1, 9))
        self.directH1_conv = _Direct9((9, 1))
        self.fuse = Conv2d(in_dim * 2, in_dim, 1, dtype=dtype)

    def forward(self, res, x):
        b, h, w, c = x.shape
        if c != self.in_dim:
            raise ValueError(f"EGLA({self.in_dim}) got {c} channels")
        # residual mask: the noise-free softmax input is spatially constant,
        # so softmax + threshold run on (b, 1, 1, c), in float32 (in bf16 a
        # probability near 0.5 would flip its bit)
        v = self.conv_du_re(res).mean(dim=(1, 2), keepdim=True)
        rm = torch.softmax(self.conv_du_re2(v).float(), dim=-1)
        res_mask = (rm >= 0.5).to(x.dtype)
        res_mask_inv = 1.0 - res_mask

        q_full, v_full = self.input_conv(x).chunk(2, dim=-1)
        w1_k, w1_b = self.directW1_conv.taps()
        h1_k, h1_b = self.directH1_conv.taps()

        # long range: rows (tokens (b h), positions w), then columns
        q_r = (res_mask * q_full).reshape(b * h, w, c)
        sparse_q = _conv9_along(q_r, w1_k, w1_b, axis=2)
        v_r = _conv9_along(v_full.reshape(b * h, w, c), w1_k, w1_b, axis=2)
        v_r = token_self_attention(sparse_q, v_r)
        q_c = _conv9_along(sparse_q.reshape(b, h, w, c), h1_k, h1_b, axis=1)
        long_out = column_self_attention(q_c.contiguous(),
                                         v_r.reshape(b, h, w, c))

        # local: inverse-masked window attention; 64-token windows take the
        # plain batched matmuls, as the JAX version does (use_pallas=False)
        ws = self.window_size
        q_w = _windows(res_mask_inv * q_full, ws)
        loc_out = token_attention_plain(q_w, _windows(v_full, ws))
        loc_out = _unwindows(loc_out, b, h, w, ws)

        out = self.fuse(torch.cat([long_out, loc_out], dim=-1))
        return out + x
