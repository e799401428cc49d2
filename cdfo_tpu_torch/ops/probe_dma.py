"""The block warp's DMA probe (``tools/microbench_dma.py``'s kernels): a
ring of (H+8, (W+8)*c) bf16 read by patch gathers or by one big copy.

* ``gather``: nblk patches of (ph, pw*c) at ``starts`` (row, lane pairs,
  flat int32 as the TPU's scalar prefetch takes them); out (1, 128) float32
  = the sum over patches of lanes 0-127 of the patch's row 0
  (``_gather_kernel``).
* ``big``: one contiguous copy of ``rows`` rows from row starts[0]; out
  (1, 128) = lanes 0-127 of its first row (``_big_kernel``). The start is
  clamped so that the rows fit the ring, as the TPU's dynamic slice clamps
  it.
* ``mk_starts``: the tool's tile-aligned starts (rows in steps of 8, lanes
  in steps of 2c), drawn from a numpy ``RandomState``.

Each wrapper launches the hand-written kernel of ``csrc/probe_dma.cu`` on a
CUDA ring, which copies every byte of every patch into shared memory (the
gather by TMA tensor copies, a patch one box or a few; the big copy by
``cp.async``), or takes the plain version on a CPU one;
launches are counted in ``launches``. Starts are clamped so that every
patch lies inside the ring (``clamp_starts``; ``mk_starts``' already do).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build as cb

_P = ctypes.c_void_p
_I = ctypes.c_int
LANES = 128
# (ph, pw) of each gather mode (patch: the smallest tile-legal block-gather
# unit; row: a 4-pixel segment; run16: 16 blocks sharing one vector)
PATCHES = {"patch": (8, 6), "row": (8, 4), "run16": (8, 66)}


def mk_starts(rng: np.random.RandomState, h: int, w: int, c: int, nblk: int,
              pw: int) -> np.ndarray:
    """(2 * nblk,) int32 (row, lane) starts: rows multiples of 8 below h,
    lanes multiples of 2c keeping pw pixels inside W + 8."""
    ys = (rng.randint(0, (h + 8 - 8) // 8, size=nblk) * 8).astype(np.int32)
    xmax = max(1, (w + 8 - pw) // 2)
    xs = (rng.randint(0, xmax, size=nblk) * 2 * c).astype(np.int32)
    return np.stack([ys, xs], 1).reshape(-1)


def big_rows(h: int, w: int, nblk: int) -> int:
    """The rows of the tool's big copy: about the bytes of nblk 5x5 patches."""
    return min(h, max(1, nblk * 5 * 5 // (w + 8)))


def clamp_starts(starts, ring_shape, ph: int, pwl: int):
    """(nblk, 2) int64 starts of patches (ph, pwl) kept inside the ring, as
    the TPU's dynamic slices clamp them, lanes taken down to a multiple of
    8 (``mk_starts``' are left as they are)."""
    st = starts.long().reshape(-1, 2)
    y = st[:, 0].clamp(0, ring_shape[0] - ph)
    x = st[:, 1].clamp(0, ring_shape[1] - pwl) // 8 * 8
    return torch.stack([y, x], 1)


def gather_plain(ring, starts, ph: int, pwl: int):
    """ring (R, L) bf16, starts (2 * nblk,) int32 -> (1, 128) float32."""
    st = clamp_starts(starts, ring.shape, ph, pwl)
    rows = ring[st[:, 0]]                                    # nblk, L
    idx = st[:, 1:2] + torch.arange(LANES, device=ring.device)
    vals = torch.gather(rows, 1, idx).double()
    return vals.sum(0, keepdim=True).float()


def big_plain(ring, starts, rows: int):
    y0 = min(max(int(starts[0]), 0), ring.shape[0] - rows)
    return ring[y0:y0 + 1, :LANES].float()


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    argtypes = {"cdfo_probe_gather_ctas": [_I] * 3,
                "cdfo_probe_gather": [_P] * 4 + [_I] * 6 + [_P],
                "cdfo_probe_big": [_P] * 3 + [_I] * 3 + [_P]}[symbol]
    return cb.kernel_function("probe_dma", symbol, argtypes)


def _check(what, ring, starts):
    if ring.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes a bfloat16 ring, got {ring.dtype}")
    if starts.dtype != torch.int32 or starts.device != ring.device:
        raise TypeError(f"{what} takes int32 starts on {ring.device}")
    if ring.dim() != 2 or ring.shape[1] % 8 or ring.shape[1] < LANES:
        raise ValueError(f"{what}: ring rows of a multiple of 8 lanes, at "
                         f"least {LANES}, got {tuple(ring.shape)}")
    cb.check_operands(what, ring)
    if not starts.is_contiguous():
        raise ValueError(f"{what} needs contiguous starts")


def gather(ring, starts, ph: int, pwl: int):
    """``gather_plain``: patches of ph rows x pwl lanes (pwl = pw * c)."""
    if not cb.on_card(ring, "probe_dma gather"):
        return gather_plain(ring, starts, ph, pwl)
    what = "probe_dma gather"
    _check(what, ring, starts)
    nblk = starts.numel() // 2
    if nblk < 1 or pwl % 8 or not LANES <= pwl <= ring.shape[1] or \
            not 0 < ph <= ring.shape[0]:
        raise ValueError(f"{what}: {nblk} patches of {ph} x {pwl} lanes (a "
                         f"multiple of 8, at least {LANES}) in a ring of "
                         f"{tuple(ring.shape)}")
    fn, _ = _kernel("cdfo_probe_gather_ctas")
    with cb.asking(ring.device):
        ctas = fn(nblk, ph, pwl)
    if ctas <= 0:
        raise ValueError(f"{what}: a patch of {ph} x {pwl} does not fit")
    part = torch.empty(ctas * LANES, dtype=torch.float32, device=ring.device)
    out = torch.empty(1, LANES, dtype=torch.float32, device=ring.device)
    cb.launch(_kernel("cdfo_probe_gather"), what, ring.device,
              ring.data_ptr(), starts.data_ptr(), part.data_ptr(),
              out.data_ptr(), *ring.shape, nblk, ph, pwl, ctas)
    gather.launches += 1
    return out


def big(ring, starts, rows: int):
    """``big_plain``."""
    if not cb.on_card(ring, "probe_dma big"):
        return big_plain(ring, starts, rows)
    what = "probe_dma big"
    _check(what, ring, starts)
    if not 0 < rows <= ring.shape[0]:
        raise ValueError(f"{what}: {rows} rows of a ring of {ring.shape[0]}")
    out = torch.empty(1, LANES, dtype=torch.float32, device=ring.device)
    cb.launch(_kernel("cdfo_probe_big"), what, ring.device, ring.data_ptr(),
              starts.data_ptr(), out.data_ptr(), *ring.shape, rows)
    big.launches += 1
    return out


gather.launches = 0
big.launches = 0
