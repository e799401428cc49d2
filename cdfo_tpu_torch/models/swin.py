"""The Swin-IR transformer stack (counterpart of ``cdfo_tpu/models/swin.py``;
the reference's `arch/SIDECVSR_our.py:641-1115`, library weight no model
calls): window partition and reverse, ``WindowAttention`` with its relative
position bias, ``Mlp``, the shifted-window block, ``BasicLayer``, ``RSTB``
and the patch embed / unembed. Tokens are (B, H*W, C) in row-major pixel
order, as ``cdfo_tpu``'s; the linear layers and LayerNorms (eps 1e-6, flax's
default) carry Swin-IR's names (``qkv``, ``proj``, ``fc1``, ``fc2``,
``norm1``, ``norm2``, ``blocks.{i}``, ``residual_group``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, _fill_uniform


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws, ws, C), windows in row-major order
    (`:747-758`)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition` (`:762-775`)."""
    c = windows.shape[-1]
    x = windows.reshape(-1, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def _relative_position_index(ws: tuple[int, int]) -> np.ndarray:
    """(n, n) index into the bias table of each query-key pair of a
    window's n = ws[0] ws[1] tokens."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 0] *= 2 * ws[1] - 1
    return rel.sum(-1)


class _Linear(nn.Linear):
    """``nn.Linear`` (weight (out, in)) drawn from the generator as torch's
    default init draws it."""

    def init_parameters(self, generator: torch.Generator):
        bound = 1.0 / self.in_features ** 0.5
        _fill_uniform(self.weight, bound, generator)
        if self.bias is not None:
            _fill_uniform(self.bias, bound, generator)


class _LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with flax's eps (1e-6), computed in
    float32 and cast back, its parameters float32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias (`:641-720`). forward(x
    (B * nW, n, C), mask (nW, n, n) or None)."""

    def __init__(self, dim: int, window_size=(8, 8), num_heads: int = 8,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        ws = self.window_size
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * ws[0] - 1) * (2 * ws[1] - 1), num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(ws)).long(),
            persistent=False)
        self.qkv = _Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.proj = _Linear(dim, dim, dtype=dtype)

    def init_parameters(self, generator: torch.Generator):
        # normal(0, 0.02) truncated at two standard deviations, as flax's
        # truncated_normal(0.02): the draws outside drawn again
        t = torch.empty(self.relative_position_bias_table.shape) \
            .normal_(0.0, 0.02, generator=generator)
        bad = t.abs() > 0.04
        while bad.any():
            t[bad] = torch.empty(int(bad.sum())).normal_(
                0.0, 0.02, generator=generator)
            bad = t.abs() > 0.04
        with torch.no_grad():
            self.relative_position_bias_table.copy_(t)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b_, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        rpb = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(n, n, heads)
        attn = attn + rpb.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, heads, n, n) \
                + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(b_, heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    """fc1, exact GELU, fc2 (`:727-743`)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = _Linear(in_features, hidden, dtype=dtype)
        self.fc2 = _Linear(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, n, n): -100 where query and key of a shifted window come from
    different regions of the rolled image, 0 elsewhere."""
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img_mask)[None, :, :, None],
                          ws).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class SwinTransformerBlock(nn.Module):
    """(Shifted-)window MSA and MLP, each pre-normed and residual
    (`:803-900`); a shifted block rolls the image by -shift before the
    windows and by +shift after, its attention mask made once for each
    image size and device. forward(x (B, H*W, C), x_size (H, W))."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = _LayerNorm(dim)
        self.attn = WindowAttention(dim, (window_size, window_size),
                                    num_heads, dtype=dtype)
        self.norm2 = _LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        self._masks = {}   # (h, w, device) -> shift mask, made once

    def _mask(self, h, w, device):
        key = (h, w, device)
        if key not in self._masks:
            self._masks[key] = _shift_attn_mask(h, w, self.window_size,
                                                self.shift_size).to(device)
        return self._masks[key]

    def forward(self, x, x_size):
        h, w = x_size
        b, l, c = x.shape
        ws, shift = self.window_size, self.shift_size
        y = self.norm1(x).reshape(b, h, w, c)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self._mask(h, w, x.device)
        yw = window_partition(y, ws).reshape(-1, ws * ws, c)
        y = window_reverse(self.attn(yw, mask).reshape(-1, ws, ws, c),
                           ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """``depth`` Swin blocks, every second one shifted by half a window
    (`:905-1000`)."""

    def __init__(self, dim: int, depth: int = 6, num_heads: int = 8,
                 window_size: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 dtype=dtype)
            for i in range(depth)])

    def forward(self, x, x_size):
        for block in self.blocks:
            x = block(x, x_size)
        return x


class RSTB(nn.Module):
    """Residual Swin transformer block: ``BasicLayer``, a 3x3 conv on the
    image, plus the input (`:1030-1115`). forward(x (B, H*W, C),
    x_size)."""

    def __init__(self, dim: int, depth: int = 6, num_heads: int = 8,
                 window_size: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size,
                                         dtype=dtype)
        self.conv = Conv2d(dim, dim, 3, 1, 1, dtype=dtype)

    def forward(self, x, x_size):
        h, w = x_size
        res = self.residual_group(x, x_size)
        b, l, c = res.shape
        return self.conv(res.reshape(b, h, w, c)).reshape(b, l, c) + x


class PatchEmbed(nn.Module):
    """(B, H, W, C) -> (B, H*W, C) tokens, LayerNormed with ``use_norm``
    (`:779-820`)."""

    def __init__(self, embed_dim: int = 64, use_norm: bool = False):
        super().__init__()
        self.norm = _LayerNorm(embed_dim) if use_norm else None

    def forward(self, x):
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c)
        return self.norm(t) if self.norm is not None else t


class PatchUnEmbed(nn.Module):
    """(B, H*W, C) -> (B, H, W, C)."""

    def forward(self, x, x_size):
        b, _, c = x.shape
        return x.reshape(b, x_size[0], x_size[1], c)
