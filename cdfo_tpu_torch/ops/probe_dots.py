"""The trunk's dot-shape probes (``tools/microbench_dots.py``'s kernels), in
the (m, n) output layout of the TPU probes:

* ``dot_case``: out (m, n) = bf16(sum over i < reps of lhs (m, k) @
  rhs[i mod nplanes] (k, n)), float32 accumulation (``_kernel``);
* ``rowpipe``: the fused ``Block_``'s per-row pipeline: for each iteration
  i, r = i mod nrows, y = sum over dx of W[:, dx*3c:(dx+1)*3c] @ u3[:,
  dx:dx+n] with u3 = u[r:r+3] as (3c, n+8), + b, lrelu, x cm, stored bf16
  as row r; out = row 0 (``_rowpipe_kernel``);
* ``kstack``: the K-stacked pipeline: us[r, dx] = u[r][:, dx:dx+n+2], y =
  W (m, 9c) @ us[r:r+3] as (9c, n+2), [:, :n], + b, lrelu, x cm, stored
  as row r; out = row 0 (``_kstack_kernel``). Rows nrows and nrows+1 of
  us are never written, so out is defined only for reps > nrows: both
  versions refuse fewer.

Each has a plain PyTorch version (``*_plain``, which computes the same
function without the loop: the products' sum through the planes' counts in
float64, and the row-0 iteration alone) and a wrapper that launches the
hand-written kernel of ``csrc/probe_dots.cu`` (``wgmma`` with both operands
in shared memory) on a CUDA tensor, or takes the plain version on a CPU
one, counting its launches in ``launches``. All operands are bfloat16 but
the float32 b and cm, as in the TPU probes. The kernels take m of 64, 128
or 256 and k a multiple of 64; the row probes take c = 64 (their weights
split by output channels) or c = 128 .. 512, a multiple of 64 (split by
input channels over a cluster of c / 64 CTAs). Two arguments serve the
tools' like-for-like comparisons and change no result: ``dot_case(...,
streamed=True)`` streams the planes from L2 where they would fit shared
memory, and ``rowpipe(..., mt=)`` caps the m-tiles (64 output channels
each) a CTA keeps, 4 by default (the kernel takes the most whose weights
fit: 2 at m = 256, c = 64), so that it can run at kstack's
(``kstack_mt``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_M = (64, 128, 256)
KERNEL_MT = (1, 2, 4)


def _counts(reps: int, nplanes: int) -> list[int]:
    return [reps // nplanes + (p < reps % nplanes) for p in range(nplanes)]


def dot_case_plain(lhs, rhs, reps: int):
    """lhs (m, k), rhs (nplanes, k, n) bf16 -> (m, n) bf16."""
    acc = sum(cnt * (lhs.double() @ rhs[p].double())
              for p, cnt in enumerate(_counts(reps, rhs.shape[0])) if cnt)
    return acc.to(torch.bfloat16)


def _rows(u, n, stacked: bool):
    """The (9c, n) operand of the row-0 iteration: u[0:3] (3, c, n+8)
    shifted by dx, in the K order of the rowpipe (dx, row, ch) or of the
    K-stacked buffer (row, dx, ch)."""
    shifted = torch.stack([u[:3, :, dx:dx + n] for dx in range(3)])  # dx r c n
    if stacked:
        shifted = shifted.transpose(0, 1)
    return shifted.reshape(-1, n)


def _epilogue(y, b, cm):
    return (F.leaky_relu(y + b.float(), 0.1) * cm.float()).to(torch.bfloat16)


def rowpipe_plain(w, b, cm, u, reps: int, nrows: int):
    """w (m, 9c) bf16, b (m, 1) and cm (1, n) float32, u (nrows+2, c, n+8)
    bf16 -> (m, n) bf16."""
    _check_rows("rowpipe", False, reps, nrows, u)
    n = cm.shape[-1]
    return _epilogue(w.float() @ _rows(u, n, False).float(), b, cm)


def kstack_plain(w, b, cm, u, reps: int, nrows: int):
    """As ``rowpipe_plain``; needs reps > nrows."""
    _check_rows("kstack", True, reps, nrows, u)
    n = cm.shape[-1]
    return _epilogue(w.float() @ _rows(u, n, True).float(), b, cm)


def _check_rows(what, stacked, reps, nrows, u):
    if nrows < 3 or u.shape[0] != nrows + 2:
        raise ValueError(f"{what}: u holds nrows + 2 rows, nrows >= 3; got "
                         f"{tuple(u.shape)} for nrows {nrows}")
    if reps < 1 or (stacked and reps <= nrows):
        raise ValueError(f"{what}: reps {reps} with nrows {nrows} (kstack "
                         "reads rows earlier iterations wrote: reps > nrows)")


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    argtypes = {"cdfo_probe_dots_parts": [_I] * 6,
                "cdfo_probe_rows_groups": [_I] * 6,
                "cdfo_probe_kstack_mt": [_I] * 3,
                "cdfo_probe_dots": [_P] * 4 + [_I] * 7 + [_P],
                "cdfo_probe_rows": [_I] * 2 + [_P] * 6 + [_I] * 6 + [_P]
                }[symbol]
    return cb.kernel_function("probe_dots", symbol, argtypes)


def kstack_mt(m: int, c: int, nrows: int) -> int:
    """The 64-channel m-tiles a CTA of the kstack kernel keeps at (m, c,
    nrows): 2 or 1, the most whose weights and stacked rows fit shared
    memory (1 where the input channels split over a cluster; card only);
    raises ValueError where nothing fits."""
    fn, _ = _kernel("cdfo_probe_kstack_mt")
    mt = fn(m, c, nrows)
    if mt <= 0:
        raise ValueError(f"probe_dots kstack: no tile of m {m} whose "
                         f"weights and stacked rows of c {c} fit shared "
                         "memory (c at most 512)")
    return mt


@functools.lru_cache(maxsize=256)
def _plan(symbol, device, *args):
    fn, _ = _kernel(symbol)
    with cb.asking(device):
        return fn(*args)


def _count(what, symbol, device, *args):
    """The kernel's partial sums (dots) or rep groups (rows) at ``args``,
    asked once a device and shape."""
    v = _plan(symbol, device, *args)
    if v <= 0:
        raise ValueError(f"{what}: no kernel plan for {args} (its weights "
                         "fit no shared memory, the row probes take c at "
                         "most 512, or the card cannot be asked)")
    return v


def _check_card(what, m, k, *tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bfloat16 operands, got {t.dtype}")
    cb.check_operands(what, *tensors)
    if m not in KERNEL_M or k % 64:
        raise ValueError(f"{what}: the kernel takes m in {KERNEL_M} and k a "
                         f"multiple of 64, got m {m}, k {k}")


def dot_case(lhs, rhs, reps: int, streamed: bool = False):
    """``dot_case_plain``; ``streamed``: the kernel streams the planes
    from L2 even where they fit shared memory."""
    if not cb.on_card(lhs, "probe_dots"):
        return dot_case_plain(lhs, rhs, reps)
    what = "probe_dots"
    m, k = lhs.shape
    nplanes, _, n = rhs.shape
    _check_card(what, m, k, lhs, rhs)
    cb.check_shapes(what, {"rhs": (rhs, (nplanes, k, n))})
    if reps < 1:
        raise ValueError(f"{what}: reps {reps}")
    # (the host's work first, so that the transpose and the kernel go out
    # back to back)
    parts = _count(what, "cdfo_probe_dots_parts", lhs.device, m, k, n,
                   nplanes, reps, int(streamed))
    part = torch.empty(parts * n * m, dtype=torch.float32, device=lhs.device)
    out = lhs.new_empty((m, n))
    lhs = lhs.contiguous()
    rhs_t = rhs.transpose(1, 2).contiguous()
    cb.launch(_kernel("cdfo_probe_dots"), what, lhs.device, rhs_t.data_ptr(),
              lhs.data_ptr(), part.data_ptr(), out.data_ptr(), m, k, n,
              nplanes, reps, parts, int(streamed))
    dot_case.launches += 1
    return out


def _rows_on_card(what, stacked, w, b, cm, u, reps, nrows, mt):
    _check_rows(what, stacked, reps, nrows, u)
    m, _ = w.shape
    _, c, n8 = u.shape
    n = n8 - 8
    _check_card(what, m, c, w, u)
    cb.check_float32(what, w.device, b, cm)
    cb.check_shapes(what, {"w": (w, (m, 9 * c)), "b": (b, (m, 1)),
                           "cm": (cm, (1, n))})
    if stacked:
        mt = kstack_mt(m, c, nrows)
    elif mt not in KERNEL_MT:
        raise ValueError(f"{what}: mt {mt} not in {KERNEL_MT}")
    u_t = u.transpose(1, 2).contiguous()
    w = w.contiguous()
    groups = _count(what, "cdfo_probe_rows_groups", w.device, int(stacked),
                    mt, m, c, n, reps)
    yscr = u.new_empty(groups * nrows * n * m)
    out = u.new_empty((m, n))
    cb.launch(_kernel("cdfo_probe_rows"), what, w.device, int(stacked), mt,
              u_t.data_ptr(), w.data_ptr(), b.data_ptr(), cm.data_ptr(),
              yscr.data_ptr(), out.data_ptr(), m, c, n, nrows, reps, groups)
    return out


def rowpipe(w, b, cm, u, reps: int, nrows: int, mt: int = 4):
    """``rowpipe_plain``; ``mt``: at most this many 64-channel m-tiles a
    CTA of the kernel."""
    if not cb.on_card(w, "probe_dots rowpipe"):
        return rowpipe_plain(w, b, cm, u, reps, nrows)
    out = _rows_on_card("probe_dots rowpipe", False, w, b, cm, u, reps, nrows,
                        mt)
    rowpipe.launches += 1
    return out


def kstack(w, b, cm, u, reps: int, nrows: int):
    """``kstack_plain``."""
    if not cb.on_card(w, "probe_dots kstack"):
        return kstack_plain(w, b, cm, u, reps, nrows)
    out = _rows_on_card("probe_dots kstack", True, w, b, cm, u, reps, nrows,
                        None)
    kstack.launches += 1
    return out


dot_case.launches = 0
rowpipe.launches = 0
kstack.launches = 0
