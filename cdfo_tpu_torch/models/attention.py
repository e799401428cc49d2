"""Attention modules of CVSR_V8 (counterparts of
``cdfo_tpu/models/attention.py``), NHWC.

* ``MDTA``: multi-head transposed (channel) self-attention.
* ``EGLA``: residual-prior-guided long-range attention (a row then a column
  1-D self-attention, through the hand-written kernel on a GPU) plus an
  inverse-masked 8x8 window attention, with the noise-free ("expected")
  residual mask or the per-pixel gumbel-sampled one ("sample", the
  reference's and the trainer's). ``EGLA(fused=True)`` runs it as
  ``ops/fused_egla``'s two kernels around the column attention, in the
  model's dtype (expected mask only).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_attention import (column_self_attention,
                                   token_attention_plain,
                                   token_self_attention)
from ..ops.fused_egla import eg1_rows, eg2_local_fuse, unwindows, windows
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
    """Multi-DConv-Head Transposed Attention over channels, bias-free (JAX
    ``use_bias=False``, which every model of the zoo builds)."""

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
    elif axis == 1 and x.ndim == 3:
        out = torch.einsum("thc,hg->tgc", x, m)
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


class EGLA(nn.Module):
    """LLongRangAttention: forward(res_prior, x) -> attended features + x.

    ``mask_mode``: ``"expected"`` thresholds the noise-free softmax (one
    bit per frame and channel); ``"sample"`` adds per-pixel gumbel noise
    before the softmax (`arch/SIDECVSR_our.py:2168-2177`), drawn from the
    ``generator`` that ``forward`` is given, or taken as the uniform draw
    ``u`` (b, h, w, c). ``fused``: the two ``ops/fused_egla`` kernels
    around the column attention (8x8 windows, expected mask only)."""

    def __init__(self, in_dim: int = 64, window_size: int = 8,
                 fused: bool = False, dtype: torch.dtype = torch.float32,
                 mask_mode: str = "expected"):
        super().__init__()
        if fused and window_size != 8:
            raise ValueError("the fused EGLA kernels take 8x8 windows, got "
                             f"window_size={window_size}")
        if fused and mask_mode != "expected":
            raise ValueError("the fused EGLA takes the expected mask only")
        self.in_dim = in_dim
        self.window_size = window_size
        self.fused = fused
        self.mask_mode = mask_mode
        self.conv_du_re = nn.Sequential(
            Conv2d(in_dim, in_dim, 1, dtype=dtype), nn.ReLU(),
            Conv2d(in_dim, in_dim, 3, 2, 2, dtype=dtype), nn.ReLU())
        self.conv_du_re2 = nn.Sequential(
            Conv2d(in_dim, in_dim, 1, dtype=dtype), nn.ReLU())
        self.input_conv = Conv2d(in_dim, in_dim * 2, 1, dtype=dtype)
        self.directW1_conv = _Direct9((1, 9))
        self.directH1_conv = _Direct9((9, 1))
        self.fuse = Conv2d(in_dim * 2, in_dim, 1, dtype=dtype)

    def _mask_logits(self, res):
        """The mask generator's softmax input, (b, c) float32: it is
        spatially constant (a 1x1 map bilinearly resized is a broadcast)."""
        v = self.conv_du_re(res).mean(dim=(1, 2), keepdim=True)
        return self.conv_du_re2(v).float()[:, 0, 0]

    def residual_mask(self, res):
        """(b, c) float32 0/1: the noise-free softmax input is spatially
        constant, so softmax + threshold run on (b, c), in float32 (in bf16
        a probability near 0.5 would flip its bit)."""
        rm = torch.softmax(self._mask_logits(res), dim=-1)
        return (rm >= 0.5).float()

    def sampled_mask(self, res, shape, generator=None, u=None):
        """(b, h, w, c) float32 0/1 of ``shape`` = x's: softmax(v + g) >=
        0.5 with g = -log(-log u) per pixel and channel, u uniform on
        [float32 tiny, 1), as ``jax.random.uniform(key, shape,
        minval=tiny, maxval=1)`` draws it. ``u`` given is used as it is;
        else it is drawn from ``generator`` on res's device. The threshold
        carries no gradient (the reference's masked_fill)."""
        if u is None:
            if generator is None:
                raise ValueError(
                    "mask_mode='sample' draws gumbel noise: give EGLA a "
                    "torch.Generator on the model's device, or the uniform "
                    "draw u")
            u = torch.rand(shape, generator=generator, device=res.device)
            u.clamp_min_(torch.finfo(torch.float32).tiny)
        elif tuple(u.shape) != tuple(shape):
            raise ValueError(f"gumbel u of shape {tuple(u.shape)}, the "
                             f"features' is {tuple(shape)}")
        with torch.no_grad():
            v = self._mask_logits(res)[:, None, None]
            g = -torch.log(-torch.log(u.to(res.device, torch.float32)))
            rm = torch.softmax(v + g, dim=-1)
            return (rm >= 0.5).float()

    def forward(self, res, x, generator=None, u=None):
        """``generator`` / ``u``: the gumbel noise of the sampled mask
        (``sampled_mask``); the expected mask takes none."""
        b, h, w, c = x.shape
        if c != self.in_dim:
            raise ValueError(f"EGLA({self.in_dim}) got {c} channels")
        if self.mask_mode == "sample":
            res_mask = self.sampled_mask(res, x.shape, generator, u)
        else:
            mask = self.residual_mask(res)
            if self.fused:
                return self._fused_call(mask, x)
            res_mask = mask[:, None, None]
        res_mask = res_mask.to(x.dtype)
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
        q_w = windows(res_mask_inv * q_full, ws)
        loc_out = token_attention_plain(q_w, windows(v_full, ws))
        loc_out = unwindows(loc_out, b, h, w, ws)

        out = self.fuse(torch.cat([long_out, loc_out], dim=-1))
        return out + x

    def _fused_call(self, mask, x):
        """eg1 -> column attention -> eg2 (``ops/fused_egla``). The mask
        (b, c) composes with the channel band into the q projection: aq =
        Wq diag(mask) Mc, cq = (bq mask) Mc + b9, bv = Wv Mc, cv = bv_in Mc
        + b9, in float32, then in x's dtype (``cdfo_tpu``'s
        ``EGLA._fused_call``)."""
        c, dt = self.in_dim, x.dtype
        kin = self.input_conv.weight[:, :, 0, 0].float().t()    # (C, 2C)
        wq, wv = kin[:, :c], kin[:, c:]
        bin_ = self.input_conv.bias.float()
        bq, bv_in = bin_[:c], bin_[c:]
        w1_k, w1_b = self.directW1_conv.taps()
        h1_k, h1_b = self.directH1_conv.taps()
        mc = _band_matrix(w1_k.float(), c)                      # channel band
        aq = torch.einsum("io,bo,oc->bic", wq, mask, mc)
        cq = (mask * bq) @ mc + w1_b
        bv = wv @ mc
        cv = (bv_in @ mc + w1_b)[None]
        h9 = torch.cat([h1_k.float(), h1_b.float()[None]])
        x = x.contiguous()

        def op(t):   # the kernels take contiguous operands of x's dtype
            return t.to(dt).contiguous()

        q_c, v_r = eg1_rows(x, op(aq), op(cq), op(bv), op(cv), h9)
        long_out = column_self_attention(q_c, v_r)
        kf = self.fuse.weight[:, :, 0, 0].float().t()            # (2C, C)
        return eg2_local_fuse(
            x, long_out, op(wq), op(bq[None]), op(wv), op(bv_in[None]),
            op(1.0 - mask), op(kf[:c]), op(kf[c:]), op(self.fuse.bias[None]))
