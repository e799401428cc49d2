"""Upsample head: two (1x1 conv + PixelShuffle(2) + lrelu) stages,
conv_last 3x3 at 4x, plus the bilinear x4 base of the LR centre, float32
out (``cdfo_tpu/ops/fused_head.py``).

* ``fused_head_plain``: plain PyTorch version, the NHWC form of
  ``cdfo_tpu/ops/fused_vjp.py::_head_twin``.
* ``fused_head``: the wrapper ``CVSRV8.head_from_trunk`` calls on the fused
  path. A CPU tensor takes the plain version; a CUDA tensor launches the
  hand-written kernel in ``csrc/fused_head.cu`` (the port of
  ``fused_head_hcw``), which never writes the 2x or 4x intermediates, or
  raises. Launches are counted in ``fused_head.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .resize import interpolate_bilinear, pixel_shuffle

CHANNELS = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _conv(t, w, b, pad):
    y = F.conv2d(t.permute(0, 3, 1, 2), w.to(t.dtype), b.to(t.dtype),
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def fused_head_plain(t, lr, w1, b1, w2, b2, wl, bl):
    """t (B, H, W, nf) trunk output; lr (B, H, W, 1); w1, w2 (4nf, nf, 1,
    1) and b1, b2 (4nf,) the upconvs; wl (1, nf, 3, 3), bl (1,) conv_last.
    Returns (B, 4H, 4W, 1) float32."""
    y = _lrelu(pixel_shuffle(_conv(t, w1, b1, 0), 2))
    y = _lrelu(pixel_shuffle(_conv(y, w2, b2, 0), 2))
    y = _conv(y, wl, bl, 1)
    base = interpolate_bilinear(lr.to(t.dtype), scale_factor=4.0)
    return (y + base).float()


def _phase_major(w, b):
    """(4C, C, 1, 1), (4C,) with torch's PixelShuffle order c*4 + p ->
    the kernel's weights (``cuda_build.kernel_weights``) and bias with
    output channel p*C + c."""
    c = w.shape[1]
    wp = w.reshape(c, 4, c, 1, 1).transpose(0, 1).reshape(4 * c, c, 1, 1)
    return (cb.kernel_weights(wp, w.dtype),
            b.reshape(c, 4).t().contiguous().reshape(4 * c))


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_head", "cdfo_fused_head",
                              [_P] * 9 + [_I] * 4 + [_P])



def fused_head(t, lr, w1, b1, w2, b2, wl, bl):
    """The upsample head + bilinear x4 base; see ``fused_head_plain``."""
    cb.forbid_grad("fused_head", t, lr, w1, b1, w2, b2, wl, bl)
    if not cb.on_card(t, "fused_head"):
        return fused_head_plain(t, lr, w1, b1, w2, b2, wl, bl)
    cb.check_operands("fused_head", t, lr, w1, b1, w2, b2, wl, bl,
                      channels=CHANNELS)
    bsz, h, wd, _ = t.shape
    if (lr.shape != (bsz, h, wd, 1) or w1.shape != (4 * CHANNELS, CHANNELS, 1, 1)
            or w2.shape != w1.shape or wl.shape != (1, CHANNELS, 3, 3)):
        raise ValueError(f"fused_head: t {tuple(t.shape)}, lr "
                         f"{tuple(lr.shape)}, upconvs {tuple(w1.shape)} "
                         f"{tuple(w2.shape)}, conv_last {tuple(wl.shape)}")
    w1p, b1p = _phase_major(w1, b1)
    w2p, b2p = _phase_major(w2, b2)
    wlp = wl[0].permute(1, 2, 0).reshape(9, CHANNELS).contiguous()
    out = torch.empty((bsz, 4 * h, 4 * wd, 1), device=t.device,
                      dtype=torch.float32)
    cb.launch(_kernel(), "fused_head", t.device, t.data_ptr(), lr.data_ptr(),
              w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(), b2p.data_ptr(),
              wlp.data_ptr(), bl.data_ptr(), out.data_ptr(),
              cb.DTYPE_CODES[t.dtype], bsz, h, wd)
    fused_head.launches += 1
    return out


fused_head.launches = 0
