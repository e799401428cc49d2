"""SCGroup tail: ``out = skip + conv3x3(x) + b`` in NHWC
(``cdfo_tpu/ops/fused_groupconv.py``).

* ``grouptail_plain``: plain PyTorch version, the NHWC form of
  ``cdfo_tpu/ops/fused_vjp.py::_grouptail_twin``.
* ``grouptail``: the wrapper the fused trunk calls. A CPU tensor takes the
  plain version; a CUDA tensor launches the hand-written kernel in
  ``csrc/fused_groupconv.cu`` (the port of ``conv3x3_residual_hcw``) or
  raises. Launches are counted in ``grouptail.launches``. The trainer
  calls it through ``ops/fused_vjp.grouptail_fused`` (a call on the card
  under autograd that is not through it raises).
* ``pack_grouptail_weights``: the kernel's weight operand (in bfloat16 the
  9 taps as swizzled ``wgmma`` stages, which the kernel keeps resident in
  shared memory); ``grouptail(..., packed=)`` takes it from a caller that
  keeps it (``models/trunk_fast.py::_GroupFast``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .fused_block2 import swizzle128

CHANNELS = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def grouptail_plain(x, skip, w, b):
    """x, skip (B, H, W, C); w (C, C, 3, 3) torch layout; b (C,)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                 padding=1)
    return skip + y.permute(0, 2, 3, 1)


def pack_grouptail_weights(w, dtype):
    """The kernel's weight operand for the (C, C, 3, 3) conv ``w`` in
    ``dtype``: bfloat16 the 9 taps as the kernel keeps them resident,
    (9, C n, C k) with tap 3 ky + kx holding B[n][k] = w[n, k, ky, kx],
    128-byte swizzled (``fused_block2.swizzle128``); float32
    ``cuda_build.kernel_weights``. Callers may keep it."""
    if dtype == torch.bfloat16:
        c = w.shape[0]
        return swizzle128(w.permute(2, 3, 0, 1).reshape(9, c, c).to(dtype))
    return cb.kernel_weights(w, dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_groupconv", "cdfo_grouptail",
                              [_P] * 5 + [_I] * 4 + [_P])


def grouptail(x, skip, w, b, packed=None):
    """skip + conv3x3(x) + b, zero-padded; NHWC, C = 64 on the card.
    ``packed``: ``pack_grouptail_weights(w, x.dtype)``, if the caller keeps
    it."""
    if not cb.on_card(x, "fused_groupconv"):
        return grouptail_plain(x, skip, w, b)
    cb.through_function("fused_groupconv", "ops/fused_vjp.grouptail_fused",
                        x, skip, w, b)
    cb.check_operands("fused_groupconv", x, skip, w, b, channels=CHANNELS)
    if skip.shape != x.shape or w.shape != (CHANNELS, CHANNELS, 3, 3):
        raise ValueError(f"fused_groupconv: x {tuple(x.shape)}, skip "
                         f"{tuple(skip.shape)}, w {tuple(w.shape)}")
    bsz, h, wd, _ = x.shape
    wk = pack_grouptail_weights(w, x.dtype) if packed is None else packed
    out = torch.empty_like(x)
    cb.launch(_kernel(), "fused_groupconv", x.device, x.data_ptr(),
              skip.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(),
              cb.DTYPE_CODES[x.dtype], bsz, h, wd)
    grouptail.launches += 1
    return out


grouptail.launches = 0
