"""EGLA with the noise-free residual mask as two kernel calls around the
column attention (``cdfo_tpu/ops/fused_egla.py``).

The mask is constant per (frame, channel), so the mask multiply and the
9-tap channel band compose into the q projection (``EGLA._fused_call``
composes them):

* ``eg1_rows``: q_s = x aq[m] + cq[m] and v = x bv + cv, the row attention
  v_r = softmax(q_s q_sᵀ) v along W, and the H-band q_c = sum_d h9[d]
  q_s[g + d - 4] + h9[9] (rows outside the image zero). Returns (q_c, v_r),
  the column stage's operands, at the input's H.
* ``eg2_local_fuse``: q = (x wq + bq) mask_inv[m] and v = x wv + bv, the
  attention inside each 8x8 window, then long fa + loc fb + bf + x: EGLA's
  output. H and W must be multiples of 8.

Matrices are (C in, C out), as in the JAX package: ``x @ aq[m]``. Both
plain versions round where the TPU kernels do: q_s and v to the dtype (the
band reads the rounded q_s), p to the dtype before p v, eg2's q and v to the
dtype, loc to the dtype before the fusion, whose sum stays float32 until the
one final rounding.

``eg1_rows_plain`` and ``eg2_local_fuse_plain`` are the plain PyTorch
versions; the wrappers take them for a CPU tensor. A CUDA tensor launches
the hand-written kernels in ``csrc/fused_egla.cu`` or raises. eg1's call is
two launches (the projection into scratch, then the rows; in bfloat16 the
projection and band walk, then the row attention with the row resident, or
past 640 positions the first design's row pass) and counts once in
``eg1_rows.launches``; ``eg2_local_fuse.launches`` counts eg2's. eg1's
matrices go to the kernel as ``pack_eg1_weights`` lays them out; aq depends
on the mask, so they are packed in each call. eg2's bfloat16 walk takes its
four matrices as they are (its loads swizzle them); its float32 twin takes
them in ``cuda_build.kernel_weights``' layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb

CHANNELS = 64
WINDOW = 8
_P = ctypes.c_void_p
_I = ctypes.c_int


def windows(t: torch.Tensor, ws: int = WINDOW) -> torch.Tensor:
    """(b, h, w, c) -> (b * h/ws * w/ws, ws*ws, c), a window's tokens in row
    order."""
    b, h, w, c = t.shape
    t = t.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def unwindows(t: torch.Tensor, b: int, h: int, w: int,
              ws: int = WINDOW) -> torch.Tensor:
    """The inverse of ``windows``."""
    c = t.shape[-1]
    t = t.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, c)


def _attend(q, v, dt):
    """softmax(q qᵀ) v over the last two dims: float32 scores and softmax, p
    rounded to ``dt``, the product in float32 rounded to ``dt``."""
    qf = q.float()
    p = torch.softmax(torch.matmul(qf, qf.transpose(-1, -2)), dim=-1)
    return torch.matmul(p.to(dt).float(), v.float()).to(dt)


def eg1_rows_plain(x, aq, cq, bv, cv, h9):
    """x (M, H, W, C); aq (M, C, C), cq (M, C), bv (C, C), cv (1, C) in x's
    dtype; h9 (10,) float32. Returns (q_c, v_r), each (M, H, W, C)."""
    dt, h = x.dtype, x.shape[1]
    xf = x.float()
    qs = (torch.matmul(xf, aq.float()[:, None])
          + cq.float()[:, None, None]).to(dt)
    v = (torch.matmul(xf, bv.float()) + cv.float()).to(dt)
    vr = _attend(qs, v, dt)
    qp = F.pad(qs.float(), (0, 0, 0, 0, 4, 4))   # 4 zero rows above, below
    qc = h9[0] * qp[:, :h]
    for d in range(1, 9):
        qc = qc + h9[d] * qp[:, d:d + h]
    return (qc + h9[9]).to(dt), vr


def _check_windows(what, x):
    if x.dim() != 4 or x.shape[1] % WINDOW or x.shape[2] % WINDOW:
        raise ValueError(f"{what} takes (M, H, W, C) with H and W multiples "
                         f"of {WINDOW}, got {tuple(x.shape)}")


def eg2_local_fuse_plain(x, long_out, wq, bq, wv, bv, mask_inv, fa, fb, bf):
    """x, long_out (M, H, W, C), H and W multiples of 8; wq, wv, fa, fb
    (C, C); bq, bv, bf (1, C); mask_inv (M, C); one dtype."""
    _check_windows("fused_egla eg2", x)
    dt = x.dtype
    m, h, w, _ = x.shape
    xf = x.float()
    q = ((torch.matmul(xf, wq.float()) + bq.float())
         * mask_inv.float()[:, None, None]).to(dt)
    v = (torch.matmul(xf, wv.float()) + bv.float()).to(dt)
    loc = unwindows(_attend(windows(q), windows(v), dt), m, h, w)
    fused = (torch.matmul(long_out.float(), fa.float())
             + torch.matmul(loc.float(), fb.float()) + bf.float())
    return (fused + xf).to(dt)


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    argtypes = {"cdfo_eg1_rows": [_P] * 10 + [_I] * 4 + [_P],
                "cdfo_eg2_local_fuse": [_P] * 11 + [_I] * 4 + [_P]}[symbol]
    return cb.kernel_function("fused_egla", symbol, argtypes)


def _matrix(w, dtype):
    """A (C in, C out) matrix in the layout the kernels read."""
    return cb.kernel_weights(w.t()[..., None, None], dtype)


def pack_eg1_weights(aq, bv, dtype):
    """eg1's (aq, bv) operands: bfloat16 aq (M, C n, C k) with B[m][n][k] =
    aq[m, k, n] and bv (C n, C k) with B[n][k] = bv[k, n] (the walk loads
    them swizzled); float32 in ``cuda_build.kernel_weights``' layout (aq
    one frame a tap)."""
    if dtype == torch.bfloat16:
        return (aq.transpose(1, 2).to(dtype).contiguous(),
                bv.t().to(dtype).contiguous())
    return cb.matrix_weights(aq.transpose(1, 2), dtype), _matrix(bv, dtype)


def eg1_rows(x, aq, cq, bv, cv, h9):
    """(q_c, v_r) of ``eg1_rows_plain``."""
    args = (x, aq, cq, bv, cv, h9)
    what = "fused_egla eg1"
    cb.forbid_grad(what, *args)
    if not cb.on_card(x, what):
        return eg1_rows_plain(*args)
    cb.check_operands(what, x, aq, cq, bv, cv, channels=CHANNELS)
    cb.check_float32(what, x.device, h9)
    m, h, w, c = x.shape
    cb.check_shapes(what, {"aq": (aq, (m, c, c)), "cq": (cq, (m, c)),
                           "bv": (bv, (c, c)), "cv": (cv, (1, c)),
                           "h9": (h9, (10,))})
    qs, v, qc, vr = (torch.empty_like(x) for _ in range(4))
    aqk, bvk = pack_eg1_weights(aq, bv, x.dtype)
    cb.launch(_kernel("cdfo_eg1_rows"), what, x.device, x.data_ptr(),
              aqk.data_ptr(), cq.data_ptr(), bvk.data_ptr(), cv.data_ptr(),
              h9.data_ptr(), qs.data_ptr(), v.data_ptr(), qc.data_ptr(),
              vr.data_ptr(), cb.DTYPE_CODES[x.dtype], m, h, w)
    eg1_rows.launches += 1
    return qc, vr


def eg2_local_fuse(x, long_out, wq, bq, wv, bv, mask_inv, fa, fb, bf):
    """``eg2_local_fuse_plain``: fuse([long, window attention]) + x."""
    args = (x, long_out, wq, bq, wv, bv, mask_inv, fa, fb, bf)
    what = "fused_egla eg2"
    cb.forbid_grad(what, *args)
    _check_windows(what, x)
    if not cb.on_card(x, what):
        return eg2_local_fuse_plain(*args)
    cb.check_operands(what, *args, channels=CHANNELS)
    m, h, w, c = x.shape
    cb.check_shapes(what, {"long_out": (long_out, x.shape),
                           **{n: (t, (c, c)) for n, t in
                              (("wq", wq), ("wv", wv), ("fa", fa),
                               ("fb", fb))},
                           **{n: (t, (1, c)) for n, t in
                              (("bq", bq), ("bv", bv), ("bf", bf))},
                           "mask_inv": (mask_inv, (m, c))})
    out = torch.empty_like(x)
    mats = (wq, wv, fa, fb)
    if x.dtype != torch.bfloat16:
        mats = tuple(_matrix(t, x.dtype) for t in mats)
    wqk, wvk, fak, fbk = mats
    cb.launch(_kernel("cdfo_eg2_local_fuse"), what, x.device, x.data_ptr(),
              long_out.data_ptr(), wqk.data_ptr(), bq.data_ptr(),
              wvk.data_ptr(), bv.data_ptr(), mask_inv.data_ptr(),
              fak.data_ptr(), fbk.data_ptr(), bf.data_ptr(), out.data_ptr(),
              cb.DTYPE_CODES[x.dtype], m, h, w)
    eg2_local_fuse.launches += 1
    return out


eg1_rows.launches = 0
eg2_local_fuse.launches = 0
