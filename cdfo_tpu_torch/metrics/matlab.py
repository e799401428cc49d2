"""MATLAB-compatible image helpers (a copy of ``cdfo_tpu/metrics/matlab.py``,
whose package imports JAX): bicubic ``imresize`` with antialiasing (the
reference reimplements it at `metric/niqe.py:46-232`) and
``fspecial('gaussian')``. Pure numpy, float64.
"""
from __future__ import annotations

import numpy as np


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    f1 = (a + 2) * ax3 - (a + 3) * ax2 + 1
    f2 = a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a
    return np.where(ax <= 1, f1, np.where(ax < 2, f2, 0.0))


def _resize_weights(in_len: int, out_len: int, scale: float,
                    antialiasing: bool):
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = 4.0 / scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1  # 0-based candidate idx
    dist = u[:, None] - (idx + 1)
    if scale < 1 and antialiasing:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    # clamp indices (replicate border, MATLAB style via aux mirroring)
    aux = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    idx = aux[np.mod(idx.astype(np.int64), aux.size)]
    # drop all-zero weight columns
    nz = np.nonzero(np.any(w != 0, axis=0))[0]
    return w[:, nz], idx[:, nz]


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB imresize (bicubic) for 2-D arrays, float64."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    oh = int(np.ceil(h * scale))
    ow = int(np.ceil(w * scale))
    wh, ih = _resize_weights(h, oh, scale, antialiasing)
    out = np.einsum("ok,okw->ow", wh, img[ih, :])
    ww, iw = _resize_weights(w, ow, scale, antialiasing)
    out = np.einsum("ok,hok->ho", ww, out[:, iw])
    return out


def fspecial_gaussian(size: int, sigma: float) -> np.ndarray:
    half = (size - 1) / 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    return g / g.sum()


def imfilter(img: np.ndarray, kernel: np.ndarray, pad_mode: str = "edge") -> np.ndarray:
    """Correlation with 'same' output size, float64.

    pad_mode: numpy pad mode — 'edge' (MATLAB replicate) or 'constant'
    (the reference's tensorflow-style 'same', zeros —
    `metric/brisque.py:40-58`).
    """
    kh, kw = kernel.shape
    pt, pb = (kh - 1) // 2, kh - 1 - (kh - 1) // 2
    pl, pr = (kw - 1) // 2, kw - 1 - (kw - 1) // 2
    padded = np.pad(img, ((pt, pb), (pl, pr)), mode=pad_mode)
    from numpy.lib.stride_tricks import sliding_window_view
    windows = sliding_window_view(padded, (kh, kw))
    return np.einsum("hwij,ij->hw", windows, kernel)


def imfilter_replicate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    return imfilter(img, kernel, "edge")
