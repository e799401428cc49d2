"""Alignment tail: ``out = RB2(RB1(gate[b] * x)) + center[b // nbr]`` in
NHWC, with ``RB(t) = t + conv3x3(relu(conv3x3(t)))``
(``cdfo_tpu/ops/fused_tail.py``, formula at its lines 6-8).

* ``resblock_pair_plain``: plain PyTorch version.
* ``resblock_pair``: the wrapper ``DualAttAlignment`` calls on the fused
  path. A CPU tensor takes the plain version; a CUDA tensor launches the
  hand-written kernel in ``csrc/fused_tail.cu`` (the port of
  ``resblock_pair_hcw``) or raises. The CALayer gate is multiplied into the
  input inside the kernel and the centre is read as ``center[b // nbr]``,
  never broadcast. Launches are counted in ``resblock_pair.launches``.
* ``pack_tail_weights``: the kernel's weight and bias operands
  (``stage_tail_weights`` in bfloat16, whose kernel streams them through
  shared memory for ``wgmma``); ``resblock_pair(..., packed=)`` takes them
  from a caller that keeps them.

Weights are the torch ``(C, C, 3, 3)`` convs and ``(C,)`` biases of
``ResidualBlock.conv1``, ``.conv2``, ``ResidualBlock1.conv1``, ``.conv2``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .fused_block2 import pointers, swizzle128

CHANNELS = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def _conv3x3(t, w, b):
    y = F.conv2d(t.permute(0, 3, 1, 2), w.to(t.dtype), b.to(t.dtype),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def resblock_pair_plain(x, center, gate, w11, b11, w12, b12, w21, b21, w22,
                        b22):
    """x (B, H, W, C); center (B // nbr, H, W, C); gate (B, C)."""
    t = x * gate[:, None, None, :].to(x.dtype)
    t = t + _conv3x3(torch.relu(_conv3x3(t, w11, b11)), w12, b12)
    t = t + _conv3x3(torch.relu(_conv3x3(t, w21, b21)), w22, b22)
    k = center.shape[0]
    return (t.reshape(k, -1, *t.shape[1:]) + center[:, None]) \
        .reshape(t.shape)


def stage_tail_weights(ws, dtype=torch.bfloat16) -> torch.Tensor:
    """The four (C, C, 3, 3) convs as the bfloat16 kernel streams them:
    (36, 64 n, 64 k), conv by conv and tap by tap (ky, kx), B[n][k] = the
    tap's weight from input channel k to output channel n, 128-byte
    swizzled (``fused_block2.swizzle128``)."""
    c = ws[0].shape[0]
    taps = torch.stack([w.permute(2, 3, 0, 1).reshape(9, c, c) for w in ws])
    return swizzle128(taps.reshape(36, c, c).to(dtype))


def pack_tail_weights(ws, bs, dtype):
    """(weights, biases) of the kernel in ``dtype``: in bfloat16 the weight
    stages of ``stage_tail_weights``, in float32 the four convs in
    ``cuda_build.kernel_weights``' layout; the biases (4, C). Callers may
    keep it."""
    if dtype == torch.bfloat16:
        wk = stage_tail_weights(ws, dtype)
    else:
        wk = torch.stack([cb.kernel_weights(w, dtype) for w in ws])
    return wk, torch.stack([b.to(dtype) for b in bs]).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_tail", "cdfo_fused_tail",
                              [_P] * 6 + [_I] * 5 + [_P])


def resblock_pair(x, center, gate, w11, b11, w12, b12, w21, b21, w22, b22,
                  packed=None):
    """RB2(RB1(gate[b] * x)) + center[b // nbr], nbr = B / center's batch;
    ``packed``: ``pack_tail_weights`` of these weights in x's dtype, if the
    caller keeps it."""
    ws = (w11, w12, w21, w22)
    bs = (b11, b12, b21, b22)
    cb.forbid_grad("fused_tail", x, center, gate, *ws, *bs)
    if x.shape[0] % center.shape[0] or x.shape[1:] != center.shape[1:]:
        raise ValueError(f"fused_tail: x {tuple(x.shape)} is not a whole "
                         f"number of neighbours per centre "
                         f"{tuple(center.shape)}")
    if not cb.on_card(x, "fused_tail"):
        return resblock_pair_plain(x, center, gate, w11, b11, w12, b12, w21,
                                   b21, w22, b22)
    cb.check_operands("fused_tail", x, center, gate, *ws, *bs,
                      channels=CHANNELS)
    if gate.shape != (x.shape[0], CHANNELS) or any(
            w.shape != (CHANNELS, CHANNELS, 3, 3) for w in ws):
        raise ValueError(f"fused_tail: gate {tuple(gate.shape)}, weights "
                         f"{[tuple(w.shape) for w in ws]}")
    bsz, h, wd, _ = x.shape
    if packed is None:
        packed = pack_tail_weights(ws, bs, x.dtype)
    out = torch.empty_like(x)
    cb.launch(_kernel(), "fused_tail", x.device, x.data_ptr(),
              center.data_ptr(), gate.data_ptr(), *pointers(packed),
              out.data_ptr(), cb.DTYPE_CODES[x.dtype], bsz, h, wd,
              bsz // center.shape[0])
    resblock_pair.launches += 1
    return out


resblock_pair.launches = 0
