"""The dual MSA of ``DualAttAlignment`` as two passes over the neighbour
images (``cdfo_tpu/ops/fused_align.py``). q is the centre frame, k the
fused key relu([w; p] W_f), v the gated warped (w) and prediction (p)
features; the two cross-MSAs share (q, k), so their gates fold into the
attention matrix:

* ``msa_stage1``: k on the fly, the statistics q^T k, q^T q, k^T k summed
  over the image (float32) and the per-channel sums of w and p (the GAP of
  the v-gates); returns stats (B, 3, C, C) and gaps (B, 2, C).
* between the passes (``DualAttAlignment.fused_msa``): the attention
  matrix, the gates, and awt = (A diag(g_w))^T, apt = (A diag(g_p))^T.
* ``msa_stage2``: o = w awt + p apt, po = o W_proj, fo = relu(po W_fA +
  q W_fB); returns fo (B, H, W, C) and the per-channel sum of fo (B, C),
  the CALayer's GAP.

The centre of image b is ``center[b // nbr]``: the wrappers take the
distinct centre frames and never broadcast them. ``msa_stage1_plain`` and
``msa_stage2_plain`` are the plain PyTorch versions; the wrappers take them
for a CPU tensor, and a CUDA tensor launches the hand-written kernels in
``csrc/fused_align.cu`` (the ports of the TPU kernels ``msa_stage1`` and
``msa_stage2``) or raises. Each call is two launches (per-block partial
sums, then their fixed-order reduction) and counts once in the wrapper's
``launches``. The bfloat16 passes are walks on ``wgmma``: stage 1 reads
``w_fuse`` as it is (its loads swizzle it; nothing is packed), stage 2
reads W_proj and W_fuse as 128-byte swizzled tiles
(``pack_stage2_weights``, which ``DualAttAlignment`` keeps with
``cuda_build.cached_pack``) and the per-image matrices, made each call from
stage 1's statistics, as ``pack_stage2_images`` stacks them (its loads
swizzle them).

Weights are torch layouts: ``w_fuse`` (C, 2C, 1, 1) the shared
``fusion_out`` conv (input channels [w; p], or [po; q]), ``w_proj`` (C, C,
1, 1) ``project_out``. Rounding follows the TPU kernels: k, o and po to the
dtype, the sums and fo's sum in float32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build as cb
from .fused_block2 import swizzle128

CHANNELS = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def _neighbours(t, center):
    """(B, H, W, C) -> (B // nbr, nbr, H, W, C) beside ``center``."""
    return t.reshape(center.shape[0], -1, *t.shape[1:])


def _fuse(a, b, w_fuse):
    """a W_fA^T + b W_fB^T in float32 (the two halves of ``w_fuse``'s
    input channels), broadcasting ``b`` over neighbours."""
    c = a.shape[-1]
    wf = w_fuse[:, :, 0, 0].float()
    return (torch.matmul(a.float(), wf[:, :c].t())
            + torch.matmul(b.float(), wf[:, c:].t()))


def msa_stage1_plain(warped, pred, center, w_fuse):
    """warped, pred (B, H, W, C); center (B // nbr, H, W, C). Returns
    (stats (B, 3, C, C), gaps (B, 2, C)), float32."""
    k = torch.relu(_fuse(warped, pred, w_fuse)).to(warped.dtype)
    kf = _neighbours(k, center).float().flatten(2, 3)   # (B/nbr, nbr, P, C)
    qf = center.float().flatten(1, 2)[:, None]           # (B/nbr, 1, P, C)
    qt = qf.transpose(2, 3)
    qk = qt @ kf
    stats = torch.stack([qk, (qt @ qf).expand_as(qk),
                         kf.transpose(2, 3) @ kf], dim=2)
    stats = stats.reshape(k.shape[0], 3, k.shape[-1], k.shape[-1])
    gaps = torch.stack([warped.float().sum(dim=(1, 2)),
                        pred.float().sum(dim=(1, 2))], dim=1)
    return stats, gaps


def msa_stage2_plain(warped, pred, center, awt, apt, w_proj, w_fuse):
    """awt, apt (B, C, C) right-multiplication matrices in the dtype.
    Returns (fo (B, H, W, C), gap (B, C) float32)."""
    dt = warped.dtype
    o = (torch.matmul(warped.float(), awt.float()[:, None])
         + torch.matmul(pred.float(), apt.float()[:, None])).to(dt)
    po = torch.matmul(o.float(), w_proj[:, :, 0, 0].float().t()).to(dt)
    fu = torch.relu(_fuse(_neighbours(po, center), center[:, None], w_fuse))
    fu = fu.reshape(po.shape)
    return fu.to(dt), fu.sum(dim=(1, 2))


def pack_stage2_weights(w_proj, w_fuse, dtype):
    """Stage 2's (projection, fusion) operands: bfloat16 W_proj as B[n][k]
    = w_proj[n, k] (C, C) and W_fuse's two halves as B[h][n][k] =
    w_fuse[n, h C + k] (2, C, C), 128-byte swizzled
    (``fused_block2.swizzle128``), which the walk keeps resident; float32
    both in ``cuda_build.kernel_weights``' layout. Callers may keep it."""
    if dtype == torch.bfloat16:
        c = w_proj.shape[0]
        halves = w_fuse[:, :, 0, 0].reshape(c, 2, c).transpose(0, 1)
        return (swizzle128(w_proj[:, :, 0, 0].to(dtype)),
                swizzle128(halves.to(dtype)))
    return cb.kernel_weights(w_proj, dtype), cb.kernel_weights(w_fuse, dtype)


def pack_stage2_images(awt, apt, dtype):
    """The per-image matrices of o = w awt + p apt: bfloat16 (B, 2, C, C),
    B[b][0][n][k] = awt[b, k, n] and B[b][1][n][k] = apt[b, k, n] (the walk
    swizzles them as it loads them); float32 [awt; apt]^T as one (C out, 2C
    in) matrix an image in ``cuda_build.matrix_weights``' layout."""
    if dtype == torch.bfloat16:
        return torch.stack([awt.transpose(1, 2), apt.transpose(1, 2)],
                           dim=1).to(dtype)
    return cb.matrix_weights(torch.cat([awt, apt], dim=1).transpose(1, 2),
                             dtype)


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    argtypes = {"cdfo_msa_stage1_workspace": [_I] * 5,
                "cdfo_msa_stage2_workspace": [_I] * 5,
                "cdfo_msa_stage1": [_P] * 5 + [_I] + [_P] * 2 + [_I] * 5 + [_P],
                "cdfo_msa_stage2": [_P] * 8 + [_I, _P] + [_I] * 5 + [_P]}[symbol]
    return cb.kernel_function("fused_align", symbol, argtypes)


def _check(what, warped, pred, center, mats, w_proj, w_fuse):
    """The checks both wrappers share; returns (B, H, W, nbr)."""
    cb.check_operands(what, warped, pred, center, *mats, *w_proj, w_fuse,
                      channels=CHANNELS)
    b, h, wd, c = warped.shape
    if (pred.shape != warped.shape or center.dim() != 4
            or center.shape[1:] != warped.shape[1:]
            or b % center.shape[0]):
        raise ValueError(f"{what}: warped {tuple(warped.shape)}, pred "
                         f"{tuple(pred.shape)} and center "
                         f"{tuple(center.shape)} are not a whole number of "
                         "neighbours per centre")
    bad = [tuple(m.shape) for m in mats if m.shape != (b, c, c)]
    bad += [tuple(w.shape) for w in w_proj if w.shape != (c, c, 1, 1)]
    if w_fuse.shape != (c, 2 * c, 1, 1):
        bad.append(tuple(w_fuse.shape))
    if bad:
        raise ValueError(f"{what}: unexpected matrix or weight shapes {bad}")
    return b, h, wd, b // center.shape[0]


def msa_stage1(warped, pred, center, w_fuse):
    """(stats, gaps) of ``msa_stage1_plain``."""
    what = "fused_align stage 1"
    cb.forbid_grad(what, warped, pred, center, w_fuse)
    if not cb.on_card(warped, what):
        return msa_stage1_plain(warped, pred, center, w_fuse)
    b, h, wd, nbr = _check(what, warped, pred, center, (), (), w_fuse)
    c, dt = CHANNELS, warped.dtype
    stats = warped.new_empty((b, 3, c, c), dtype=torch.float32)
    gaps = warped.new_empty((b, 2, c), dtype=torch.float32)
    ws = cb.workspace(_kernel("cdfo_msa_stage1_workspace"), what,
                      warped.device, b, h, wd, nbr, cb.DTYPE_CODES[dt])
    fk = w_fuse if dt == torch.bfloat16 else cb.kernel_weights(w_fuse, dt)
    cb.launch(_kernel("cdfo_msa_stage1"), what, warped.device,
              warped.data_ptr(), pred.data_ptr(), center.data_ptr(),
              fk.data_ptr(), ws.data_ptr(), ws.numel(), stats.data_ptr(),
              gaps.data_ptr(), cb.DTYPE_CODES[dt], b, h, wd, nbr)
    msa_stage1.launches += 1
    return stats, gaps


def msa_stage2(warped, pred, center, awt, apt, w_proj, w_fuse, packed=None):
    """(fo, gap) of ``msa_stage2_plain``. ``packed``:
    ``pack_stage2_weights`` of these weights in the dtype, if the caller
    keeps it."""
    what = "fused_align stage 2"
    args = (warped, pred, center, awt, apt, w_proj, w_fuse)
    cb.forbid_grad(what, *args)
    if not cb.on_card(warped, what):
        return msa_stage2_plain(*args)
    b, h, wd, nbr = _check(what, warped, pred, center, (awt, apt),
                           (w_proj,), w_fuse)
    c, dt = CHANNELS, warped.dtype
    fo = torch.empty_like(warped)
    gap = warped.new_empty((b, c), dtype=torch.float32)
    ws = cb.workspace(_kernel("cdfo_msa_stage2_workspace"), what,
                      warped.device, b, h, wd, nbr, cb.DTYPE_CODES[dt])
    ak = pack_stage2_images(awt, apt, dt)
    if packed is None:
        packed = pack_stage2_weights(w_proj, w_fuse, dt)
    pk, fk = packed
    cb.launch(_kernel("cdfo_msa_stage2"), what, warped.device,
              warped.data_ptr(), pred.data_ptr(), center.data_ptr(),
              ak.data_ptr(), pk.data_ptr(), fk.data_ptr(), fo.data_ptr(),
              ws.data_ptr(), ws.numel(), gap.data_ptr(), cb.DTYPE_CODES[dt],
              b, h, wd, nbr)
    msa_stage2.launches += 1
    return fo, gap


msa_stage1.launches = 0
msa_stage2.launches = 0
