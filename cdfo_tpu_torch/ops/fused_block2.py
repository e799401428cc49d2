"""The whole SCNet ``Block_`` in NHWC (``cdfo_tpu/ops/fused_block2.py``):

    out = x + body(x) + up(body(down(x))) + down(body(up(x)))

with ``body`` = conv3x3 (C -> 4C), lrelu(0.1), conv3x3 (4C -> C), and
``up`` / ``down`` = a 1x1 conv then a bilinear 2x / 0.5x resize
(align_corners=False), as ``models/trunk.py::BlockS``.

* ``scale_block_plain``: plain PyTorch version, the NHWC form of
  ``cdfo_tpu/ops/fused_vjp.py::_block_twin``.
* ``fold_down_conv2``: the down2-folded conv2 as one stride-2 4x4 conv, a
  host weight transform (the algebra of ``fused_block2.fold_down_conv2``,
  without its TPU packing).
* ``scale_block``: the wrapper the fused trunk calls. A CPU tensor takes
  the plain version; a CUDA tensor launches the hand-written kernel in
  ``csrc/fused_block2.cu`` (the port of ``scale_block_hcw``), which keeps
  every 2x and 0.5x intermediate on chip, or raises. In bfloat16 the
  kernel runs its products on ``wgmma`` with every weight tap streamed
  into shared memory (``stage_weights``). Launches are counted
  in ``scale_block.launches``.

H and W must be even (the reference ``Block_`` is undefined otherwise);
both paths raise ``ValueError`` on odd extents.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .resize import interpolate_bilinear

CHANNELS = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def _conv(t, w, b, pad, stride=1):
    y = F.conv2d(t.permute(0, 3, 1, 2), w.to(t.dtype), b.to(t.dtype),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def scale_block_plain(x, w1, b1, w2, b2, wd, bd, wu, bu):
    """x (B, H, W, C); torch-layout weights: w1 (4C, C, 3, 3), w2 (C, 4C,
    3, 3), wd/wu (C, C, 1, 1) the down_0/up_0 convs; biases (out,)."""
    def body(t):
        return _conv(F.leaky_relu(_conv(t, w1, b1, 1), 0.1), w2, b2, 1)

    def down(t):
        return interpolate_bilinear(_conv(t, wd, bd, 0), scale_factor=0.5)

    def up(t):
        return interpolate_bilinear(_conv(t, wu, bu, 0), scale_factor=2.0)

    return x + body(x) + up(body(down(x))) + down(body(up(x)))


def fold_down_conv2(w2: torch.Tensor) -> torch.Tensor:
    """(cout, cmid, 3, 3) conv2 -> (cout, cmid, 4, 4) weights (float32, or
    float64 for a float64 conv2) of
    the stride-2, padding-1 conv equal to down2 . conv2 (conv2 at 2x with
    zero padding, then the 2x2 mean that bilinear 0.5x is):
    T[ey, ex] = 0.25 * sum over q, p in {0, 1} of W2[ey - q, ex - p]."""
    w = w2.to(torch.promote_types(w2.dtype, torch.float32))
    t = w.new_zeros(*w.shape[:2], 4, 4)
    for q in (0, 1):
        for p in (0, 1):
            t[:, :, q:q + 3, p:p + 3] += w
    return 0.25 * t


@functools.lru_cache(maxsize=None)
def _swizzle_index(rows: int, device: torch.device) -> torch.Tensor:
    """The ``swizzle128`` source chunk of each (row, chunk), flattened, kept
    on ``device`` so that a pack copies nothing from the host."""
    row = torch.arange(rows)[:, None]
    return (8 * row + (torch.arange(8)[None, :] ^ (row % 8))).reshape(-1) \
        .to(device)


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """(..., rows, 64) bfloat16 with each row's 16-byte chunk c moved to
    chunk c ^ (row % 8): the 128-byte swizzle in which ``wgmma`` reads a
    K-major tile from shared memory (``csrc/wgmma_tile.cuh``)."""
    rows = t.shape[-2]
    chunks = t.reshape(*t.shape[:-2], rows * 8, 8)
    return chunks.index_select(-2, _swizzle_index(rows, t.device)) \
        .reshape(t.shape)


def stage_weights(w1, w2, dtype=torch.bfloat16) -> torch.Tensor:
    """conv1, the folded conv2 and conv2 as the bfloat16 kernel streams
    them: (4 chunks, 34 stages, 64 n, 64 k), per chunk conv1's 9 taps, the
    fold's 16 and conv2's 9, one 64 x 64 tap per stage, B[n][k] with k the
    reduced channel, 128-byte swizzled. Chunk ch holds conv1's output channels 64ch .. 64ch+63 and the
    matching input channels of the fold and conv2."""
    c = w2.shape[0]
    taps1 = w1.permute(2, 3, 0, 1).reshape(9, 4, c, c)           # tap, ch, n, k
    fold = fold_down_conv2(w2).permute(2, 3, 0, 1).reshape(16, c, 4, c)
    taps2 = w2.permute(2, 3, 0, 1).reshape(9, c, 4, c)
    stages = torch.cat([taps1.to(dtype), fold.permute(0, 2, 1, 3).to(dtype),
                        taps2.permute(0, 2, 1, 3).to(dtype)], dim=0)
    return swizzle128(stages.transpose(0, 1))


def pack_weights(w1, b1, w2, b2, wd, bd, wu, bu, dtype):
    """The kernel's operands in ``dtype``, in the C interface's order (w1,
    b1, w2, b2, wf, wd, bd, wu, bu): each conv in ``cuda_build.kernel_weights``'
    layout and wf the down2-folded conv2; in bfloat16 w1's place holds
    conv1, conv2 and the fold as ``stage_weights`` and w2 and wf are None.
    Callers cache it."""
    def kw(w):
        return cb.kernel_weights(w, dtype)

    if dtype == torch.bfloat16:
        return (stage_weights(w1, w2, dtype), b1.to(dtype), None,
                b2.to(dtype), None, kw(wd), bd.to(dtype), kw(wu),
                bu.to(dtype))
    return (kw(w1), b1.to(dtype), kw(w2), b2.to(dtype),
            kw(fold_down_conv2(w2)), kw(wd), bd.to(dtype), kw(wu),
            bu.to(dtype))


def pointers(packed):
    """The nine weight pointers of the C interface (NULL for None)."""
    return [None if t is None else t.data_ptr() for t in packed]


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_block2", "cdfo_fused_block2",
                              [_P] * 11 + [_I] * 4 + [_P])



def scale_block(x, w1, b1, w2, b2, wd, bd, wu, bu, packed=None):
    """The Block_ of ``scale_block_plain``; ``packed``: this block's
    ``pack_weights`` in x's dtype, if the caller keeps it."""
    params = (w1, b1, w2, b2, wd, bd, wu, bu)
    cb.forbid_grad("fused_block2", x, *params)
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"fused_block2 needs even H and W (the reference "
                         f"Block_ is undefined otherwise), got "
                         f"{tuple(x.shape)}")
    if not cb.on_card(x, "fused_block2"):
        return scale_block_plain(x, *params)
    cb.check_operands("fused_block2", x, *params, channels=CHANNELS)
    c = CHANNELS
    if (w1.shape != (4 * c, c, 3, 3) or w2.shape != (c, 4 * c, 3, 3)
            or wd.shape != (c, c, 1, 1) or wu.shape != (c, c, 1, 1)):
        raise ValueError(f"fused_block2: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(wd.shape)}, "
                         f"{tuple(wu.shape)}")
    if packed is None:
        packed = pack_weights(*params, x.dtype)
    bsz, h, wdt, _ = x.shape
    out = torch.empty_like(x)
    cb.launch(_kernel(), "fused_block2", x.device, x.data_ptr(),
              *pointers(packed), out.data_ptr(),
              cb.DTYPE_CODES[x.dtype], bsz, h, wdt)
    scale_block.launches += 1
    return out


scale_block.launches = 0
