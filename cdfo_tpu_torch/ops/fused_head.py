"""Upsample head: two (1x1 conv + PixelShuffle(2) + lrelu) stages,
conv_last 3x3 at 4x, plus the bilinear x4 base of the LR centre, float32
out (``cdfo_tpu/ops/fused_head.py``).

* ``fused_head_plain``: plain PyTorch version, the NHWC form of
  ``cdfo_tpu/ops/fused_vjp.py::_head_twin``.
* ``fused_head``: the wrapper ``CVSRV8.head_from_trunk`` calls on the fused
  path. A CPU tensor takes the plain version; a CUDA tensor launches the
  hand-written kernel in ``csrc/fused_head.cu`` (the port of
  ``fused_head_hcw``), which never writes the 2x or 4x intermediates, or
  raises. Launches are counted in ``fused_head.launches``. The trainer
  calls it through ``ops/fused_vjp.head_fused`` (a call on the card under
  autograd that is not through it raises).
* ``pack_head_weights``: the kernel's weight and bias operands (in
  bfloat16 ``stage_head_weights``, which the kernel keeps resident in
  shared memory for ``wgmma``); ``fused_head(..., packed=)`` takes them
  from a caller that keeps them (``CVSRV8``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .fused_block2 import pointers, swizzle128
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


def _phase_rows(w):
    """(4C, C, 1, 1) with torch's PixelShuffle order c*4 + p -> (4C out,
    C in) with output channel p*C + c."""
    c = w.shape[1]
    return w.reshape(c, 4, c).transpose(0, 1).reshape(4 * c, c)


def _phase_bias(b):
    """(4C,) likewise: entry p*C + c is b[c*4 + p]."""
    return b.reshape(-1, 4).t().contiguous().reshape(-1)


def stage_head_weights(w1, w2, wl, dtype=torch.bfloat16) -> torch.Tensor:
    """The bfloat16 kernel's resident weights, (8 * 64 + 16, 64): upconv1's
    four phase blocks (rows 64p .. 64p + 63: B[n][k] = w1[4n + p, k]), then
    upconv2's, then conv_last as the tap matrix (row 3ky + kx: B[tap][c] =
    wl[0, c, ky, kx], rows 9 .. 15 zero), 128-byte swizzled
    (``fused_block2.swizzle128``)."""
    c = w1.shape[1]
    taps = wl.new_zeros(16, c)
    taps[:9] = wl[0].permute(1, 2, 0).reshape(9, c)
    rows = torch.cat([_phase_rows(w1), _phase_rows(w2), taps])
    return swizzle128(rows.to(dtype))


def pack_head_weights(w1, b1, w2, b2, wl, dtype):
    """The kernel's (w1, b1, w2, b2, wl) operands in ``dtype``, the biases
    phase-major: in bfloat16 w1's place holds ``stage_head_weights`` and
    w2, wl are None; in float32 the phase-major upconvs in
    ``cuda_build.kernel_weights``' layout and conv_last as [9 taps][C].
    Callers may keep it."""
    c = w1.shape[1]
    b1p, b2p = _phase_bias(b1).to(dtype), _phase_bias(b2).to(dtype)
    if dtype == torch.bfloat16:
        return stage_head_weights(w1, w2, wl, dtype), b1p, None, b2p, None
    return (cb.kernel_weights(_phase_rows(w1)[..., None, None], dtype), b1p,
            cb.kernel_weights(_phase_rows(w2)[..., None, None], dtype), b2p,
            wl[0].permute(1, 2, 0).reshape(9, c).to(dtype).contiguous())


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_head", "cdfo_fused_head",
                              [_P] * 9 + [_I] * 4 + [_P])


def fused_head(t, lr, w1, b1, w2, b2, wl, bl, packed=None):
    """The upsample head + bilinear x4 base; see ``fused_head_plain``.
    ``packed``: ``pack_head_weights`` of these weights in t's dtype, if the
    caller keeps it."""
    if not cb.on_card(t, "fused_head"):
        return fused_head_plain(t, lr, w1, b1, w2, b2, wl, bl)
    cb.through_function("fused_head", "ops/fused_vjp.head_fused", t, lr, w1,
                        b1, w2, b2, wl, bl)
    cb.check_operands("fused_head", t, lr, w1, b1, w2, b2, wl, bl,
                      channels=CHANNELS)
    bsz, h, wd, _ = t.shape
    if (lr.shape != (bsz, h, wd, 1) or w1.shape != (4 * CHANNELS, CHANNELS, 1, 1)
            or w2.shape != w1.shape or wl.shape != (1, CHANNELS, 3, 3)):
        raise ValueError(f"fused_head: t {tuple(t.shape)}, lr "
                         f"{tuple(lr.shape)}, upconvs {tuple(w1.shape)} "
                         f"{tuple(w2.shape)}, conv_last {tuple(wl.shape)}")
    if packed is None:
        packed = pack_head_weights(w1, b1, w2, b2, wl, t.dtype)
    out = torch.empty((bsz, 4 * h, 4 * wd, 1), device=t.device,
                      dtype=torch.float32)
    cb.launch(_kernel(), "fused_head", t.device, t.data_ptr(), lr.data_ptr(),
              *pointers(packed), bl.data_ptr(), out.data_ptr(),
              cb.DTYPE_CODES[t.dtype], bsz, h, wd)
    fused_head.launches += 1
    return out


fused_head.launches = 0
