"""Bilinear resize and pixel shuffle in NHWC (counterparts of
``cdfo_tpu/ops/resize.py``, which reproduces torch's own semantics, so here
they are torch's operators on an NCHW view)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, scale_factor: float | None = None,
                         size: tuple[int, int] | None = None) -> torch.Tensor:
    """Bilinear resize of NHWC ``x``, torch ``align_corners=False``.

    Exactly one of ``scale_factor`` / ``size`` must be given. Output spatial
    dims are ``floor(in * scale_factor)``; with a scale factor the source
    step is ``1 / scale_factor`` (torch's ``recompute_scale_factor=False``).
    """
    if (scale_factor is None) == (size is None):
        raise ValueError("give exactly one of scale_factor and size")
    _, h, w, _ = x.shape
    if size is None:
        oh, ow = int(h * scale_factor), int(w * scale_factor)
    else:
        oh, ow = size
    if (oh, ow) == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size,
                      scale_factor=scale_factor, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC pixel shuffle with torch channel ordering: input channel
    ``c*r*r + dy*r + dx`` lands on output channel ``c`` at (dy, dx)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h, dy, w, dx, c
    return x.reshape(b, h * r, w * r, c)
