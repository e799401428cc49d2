"""Deformable convolution v1/v2 in NHWC (counterpart of
``cdfo_tpu/ops/deform_conv.py``, which is plain XLA: no TPU kernel).

Per kernel tap: one bilinear gather of every deformable group's channels at
``(y*stride - pad + i*dil + dy, x*stride - pad + j*dil + dx)``, each of the
four corners read only where it lies inside the image (zero outside, as
the reference's CUDA im2col and ``cdfo_tpu``'s ``_bilinear_gather``),
optionally modulated by the mask; the taps' samples fill the
(B, Ho, Wo, K, Cin) column tensor in x's dtype, and one matmul per weight
group contracts (K, Cin / groups), as ``cdfo_tpu`` does: the products are
summed in float32 and rounded to x's dtype once, not once per tap.

Offset channel layout of the reference's CUDA op, channels-last:
(B, Ho, Wo, 2*G*K), ``[dy, dx]`` interleaved per tap, deformable group
major; mask (B, Ho, Wo, G*K), applied as given.
"""
from __future__ import annotations

from typing import Optional

import torch


def _tap_samples(x, sy, sx):
    """x (B, H, W, G, cpg); sy, sx (B, Ho, Wo, G) float32 sample
    coordinates. Returns float32 (B, Ho, Wo, G, cpg): the bilinear sample of
    each group's channels, each corner zero outside the image."""
    b, h, w, g, cpg = x.shape
    flat = x.reshape(b * h * w * g, cpg)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    y0, x0 = y0.long(), x0.long()
    bi = torch.arange(b, device=x.device).view(b, 1, 1, 1)
    gi = torch.arange(g, device=x.device).view(1, 1, 1, g)
    out = None
    for dy, dx, wt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = ((bi * h + yy.clamp(0, h - 1)) * w + xx.clamp(0, w - 1)) * g + gi
        v = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, cpg)
        term = v.float() * (wt * inside)[..., None]
        out = term if out is None else out + term
    return out


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 0, dilation: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """NHWC deformable convolution.

    x (B, H, W, Cin); offset (B, Ho, Wo, 2*G*K); weight in the torch layout
    (Cout, Cin // groups, kh, kw); bias (Cout,); mask (B, Ho, Wo, G*K) or
    None (v1). ``groups`` are the weight's groups, G the deformable groups
    (from the offset's channels). Returns (B, Ho, Wo, Cout) in x's dtype.
    """
    b, h, w, cin = x.shape
    cout, cin_g, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * padding - (dilation * (kh - 1) + 1)) // stride + 1
    wo = (w + 2 * padding - (dilation * (kw - 1) + 1)) // stride + 1
    g = offset.shape[-1] // (2 * k)
    if offset.shape != (b, ho, wo, 2 * g * k) or cin % g or \
            cin_g * groups != cin:
        raise ValueError(f"deform_conv2d: x {tuple(x.shape)}, offset "
                         f"{tuple(offset.shape)}, weight "
                         f"{tuple(weight.shape)}, groups {groups}")
    dt, dev = x.dtype, x.device
    xg = x.reshape(b, h, w, g, cin // g)
    off = offset.float().reshape(b, ho, wo, g, k, 2)
    base_y = (torch.arange(ho, device=dev, dtype=torch.float32) * stride
              - padding).view(1, ho, 1, 1)
    base_x = (torch.arange(wo, device=dev, dtype=torch.float32) * stride
              - padding).view(1, 1, wo, 1)
    m = None if mask is None else mask.to(dt).reshape(b, ho, wo, g, k)
    opg = cout // groups
    cols = torch.empty(b, ho, wo, k, groups, cin_g, dtype=dt, device=dev)
    for t in range(k):
        i, j = divmod(t, kw)
        v = _tap_samples(xg, off[..., t, 0] + base_y + i * dilation,
                         off[..., t, 1] + base_x + j * dilation).to(dt)
        if m is not None:
            v = v * m[..., t, None]
        cols[:, :, :, t] = v.reshape(b, ho, wo, groups, cin_g)
    # (K, groups, Cin/groups, Cout/groups): tap t's slice for weight group gi
    wk = weight.to(dt).reshape(groups, opg, cin_g, k).permute(3, 0, 2, 1)
    out = torch.einsum("bhwkgc,kgco->bhwgo", cols, wk).reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
