"""The SCNet ``Block_`` body pair in NHWC (``cdfo_tpu/ops/fused_block.py``):

    out = conv3x3_256->64(lrelu_0.1(conv3x3_64->256(x) + b1)) + b2 (+ x)

with zero padding 1 for both convs. No model path runs it; the trunk
microbenchmark (``cdfo_tpu_torch/tools/microbench_trunk.py``) measures it
against the eager pair.

* ``block_body_plain``: plain PyTorch version. It rounds where the TPU
  kernel ``block_body_hcw`` rounds: the 256-channel y in the working dtype,
  b2 and the residual added to conv2's float32 sum before the one output
  rounding.
* ``block_body``: the wrapper. A CPU tensor takes the plain version; a CUDA
  tensor launches the hand-written kernel in ``csrc/fused_block.cu`` (the
  port of ``block_body_hcw``), which keeps y on chip, or raises. Launches
  are counted in ``block_body.launches``.
* ``pack_body_weights``: the kernel's weight operand (in bfloat16 the
  slices that the 4 CTAs of a cluster keep resident);
  ``block_body(..., packed=)`` takes it from a caller that keeps it.

Weights are HWIO, as ``fused_block_body`` takes them: w1 (3, 3, 64, 256),
b1 (256,), w2 (3, 3, 256, 64), b2 (64,).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .fused_block2 import swizzle128

CHANNELS = 64
MID = 4 * CHANNELS
_P = ctypes.c_void_p
_I = ctypes.c_int


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1)


def block_body_plain(x, w1, b1, w2, b2, residual: bool = True):
    """x (B, H, W, C) NHWC; returns (B, H, W, C) in x's dtype."""
    dt = x.dtype
    xf = x.float().permute(0, 3, 1, 2)
    y = F.conv2d(xf, _oihw(w1).float(), b1.float(), padding=1)
    y = F.leaky_relu(y, 0.1).to(dt).float()
    out = F.conv2d(y, _oihw(w2).float(), b2.float(), padding=1)
    if residual:
        out = out + xf
    return out.permute(0, 2, 3, 1).to(dt).contiguous()


def pack_body_weights(w1, w2, dtype):
    """The kernel's weight operand for HWIO ``w1`` and ``w2`` in ``dtype``:
    bfloat16 (4, 2, 9, C n, C k), for CTA q of a cluster conv1's taps
    B[n][k] = w1[ky, kx, k, 64 q + n] and conv2's B[n][k] = w2[ky, kx,
    64 q + k, n] (tap 3 ky + kx), 128-byte swizzled (``fused_block2.
    swizzle128``); float32 ``cuda_build.kernel_weights`` of each, a pair.
    Callers may keep it."""
    if dtype == torch.bfloat16:
        c = w2.shape[-1]
        q = w1.shape[-1] // c
        taps1 = w1.reshape(9, c, q, c).permute(2, 0, 3, 1)   # q, tap, n, k
        taps2 = w2.reshape(9, q, c, c).permute(1, 0, 3, 2)
        return swizzle128(torch.stack([taps1, taps2], dim=1).to(dtype))
    return (cb.kernel_weights(_oihw(w1), dtype),
            cb.kernel_weights(_oihw(w2), dtype))


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_block", "cdfo_fused_block",
                              [_P] * 6 + [_I] * 5 + [_P])


def block_body(x, w1, b1, w2, b2, residual: bool = True, packed=None):
    """The body pair of ``block_body_plain``. ``packed``:
    ``pack_body_weights(w1, w2, x.dtype)``, if the caller keeps it."""
    cb.forbid_grad("fused_block", x, w1, b1, w2, b2)
    if not cb.on_card(x, "fused_block"):
        return block_body_plain(x, w1, b1, w2, b2, residual)
    what = "fused_block"
    cb.check_operands(what, x, w1, b1, w2, b2, channels=CHANNELS)
    c = CHANNELS
    cb.check_shapes(what, {"w1": (w1, (3, 3, c, MID)), "b1": (b1, (MID,)),
                           "w2": (w2, (3, 3, MID, c)), "b2": (b2, (c,))})
    if x.dim() != 4:
        raise ValueError(f"{what} takes NHWC x, got {tuple(x.shape)}")
    bsz, h, wd, _ = x.shape
    out = torch.empty_like(x)
    wk = pack_body_weights(w1, w2, x.dtype) if packed is None else packed
    wk1, wk2 = (wk, None) if x.dtype == torch.bfloat16 else wk
    cb.launch(_kernel(), what, x.device, x.data_ptr(), wk1.data_ptr(),
              b1.data_ptr(), None if wk2 is None else wk2.data_ptr(),
              b2.data_ptr(), out.data_ptr(), cb.DTYPE_CODES[x.dtype], bsz, h,
              wd, int(residual))
    block_body.launches += 1
    return out


block_body.launches = 0
