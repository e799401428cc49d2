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

Weights are the torch ``(C, C, 3, 3)`` convs and ``(C,)`` biases of
``ResidualBlock.conv1``, ``.conv2``, ``ResidualBlock1.conv1``, ``.conv2``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb

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


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_tail", "cdfo_fused_tail",
                              [_P] * 6 + [_I] * 5 + [_P])



def resblock_pair(x, center, gate, w11, b11, w12, b12, w21, b21, w22, b22):
    """RB2(RB1(gate[b] * x)) + center[b // nbr], nbr = B / center's batch."""
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
    wk = torch.stack([cb.kernel_weights(w, x.dtype) for w in ws])
    bk = torch.stack(bs).contiguous()
    out = torch.empty_like(x)
    cb.launch(_kernel(), "fused_tail", x.device, x.data_ptr(),
              center.data_ptr(), gate.data_ptr(), wk.data_ptr(),
              bk.data_ptr(), out.data_ptr(), cb.DTYPE_CODES[x.dtype], bsz, h,
              wd, bsz // center.shape[0])
    resblock_pair.launches += 1
    return out


resblock_pair.launches = 0
