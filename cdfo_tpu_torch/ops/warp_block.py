"""The block-gather ring warp (``cdfo_tpu/ops/warp_block.py``): the warp of
``ops/warp.py::flow_warp_ring`` (bilinear, zeros padding,
``align_corners=True``), computed per 4x4 block where the flow allows it.

Coding-prior flows are constant over 4x4 blocks (HEVC motion-vector
granularity, which ``mv2mvs`` keeps), so a block whose 16 flows are equal
needs one (5, 5) source patch, blended H first and W second with the block's
two weights and masked per pixel (the "patch path"). Any other block, and
every block of the bottom 4 rows (which the JAX wrapper always computes per
pixel, because the eval pipeline's row padding mixes them), takes the
per-pixel 4-tap form of ``flow_warp_ring``. Both forms are the same function
of ring and flow up to float32 rounding (2e-5 relative).

* ``block_paths``: which blocks take the patch path.
* ``flow_warp_ring_block_plain``: plain PyTorch version, path chosen per
  block as the kernel chooses it.
* ``flow_warp_ring_block``: the wrapper ``CVSRV8.warp_neighbours`` calls
  under ``block_warp``. A CPU tensor takes the plain version; a CUDA tensor
  launches ``csrc/warp_block.cu`` (the port of ``_block_warp_call`` with the
  per-pixel gather and the choice between them in the same launch, so the
  host decides nothing and never waits for the flows; in bfloat16 a walk
  that visits the images of one place together, so that each ring slot
  is read from device memory about once), or raises. Launches are counted
  in ``flow_warp_ring_block.launches``.

The ring is (L, H, W, C) as the engine keeps it, without the TPU layout's
zero border; H and W must be multiples of 4 and, on the card, C = 64.
``frame_idx`` within [0, L) is the caller's contract.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build as cb
from .warp import _taps

CHANNELS = 64
BLOCK = 4
_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(ring, frame_idx, flow):
    if (ring.ndim != 4 or flow.ndim != 4 or flow.shape[-1] != 2
            or flow.shape[1:3] != ring.shape[1:3]
            or frame_idx.shape != flow.shape[:1]):
        raise ValueError(f"warp_block: bad shapes ring={tuple(ring.shape)} "
                         f"frame_idx={tuple(frame_idx.shape)} "
                         f"flow={tuple(flow.shape)}")
    if ring.shape[1] % BLOCK or ring.shape[2] % BLOCK:
        raise ValueError(f"warp_block needs H and W multiples of {BLOCK}, "
                         f"got {tuple(ring.shape)}")


def block_paths(flow: torch.Tensor) -> torch.Tensor:
    """flow (B, H, W, 2) -> bool (B, H/4, W/4): True where a block takes
    the patch path (its 16 flows are equal and it is not in the bottom 4
    rows)."""
    b, h, w, _ = flow.shape
    fb = flow.reshape(b, h // BLOCK, BLOCK, w // BLOCK, BLOCK, 2)
    paths = (fb == fb[:, :, :1, :, :1]).all(dim=5).all(dim=4).all(dim=2)
    paths[:, -1] = False
    return paths


def _patch_blend(ring, frame_idx, flow):
    """Every block by the patch form, from its top-left pixel's flow:
    float32 (B, H, W, C)."""
    l, h, w, c = ring.shape
    b = flow.shape[0]
    dev = ring.device
    f = flow.float()[:, ::BLOCK, ::BLOCK]
    gx = torch.arange(0, w, BLOCK, dtype=torch.float32, device=dev)
    gy = torch.arange(0, h, BLOCK, dtype=torch.float32, device=dev)
    sx = gx[None, None, :] + f[..., 0]
    sy = gy[None, :, None] + f[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx = (sx - x0)[..., None, None, None]
    wy = (sy - y0)[..., None, None, None]
    x0i, y0i = x0.long(), y0.long()
    i5 = torch.arange(BLOCK + 1, device=dev)
    yy = y0i[..., None, None] + i5[:, None]
    xx = x0i[..., None, None] + i5[None, :]
    inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
    idx = (frame_idx.long().reshape(b, 1, 1, 1, 1) * (h * w)
           + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
    p = ring.reshape(l * h * w, c).index_select(0, idx.reshape(-1)) \
        .reshape(*idx.shape, c).float() * inside[..., None]
    hr = p[..., 0:BLOCK, :, :] * (1 - wy) + p[..., 1:BLOCK + 1, :, :] * wy
    o = hr[..., :, 0:BLOCK, :] * (1 - wx) + hr[..., :, 1:BLOCK + 1, :] * wx
    i4 = torch.arange(BLOCK, device=dev)
    ry = y0i[..., None] + i4
    rx = x0i[..., None] + i4
    keep = (((ry >= -1) & (ry <= h - 1))[..., :, None]
            & ((rx >= -1) & (rx <= w - 1))[..., None, :]).float()
    o = o * keep[..., None]
    return o.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def flow_warp_ring_block_plain(ring, frame_idx, flow, return_paths=False):
    """ring (L, H, W, C); frame_idx (B,) int ring slots; flow (B, H, W, 2)
    (dx, dy). Returns (B, H, W, C) in the ring's dtype, blended in float32
    and rounded once; with ``return_paths`` also ``block_paths(flow)``."""
    _check(ring, frame_idx, flow)
    paths = block_paths(flow)
    pick = paths.repeat_interleave(BLOCK, dim=1) \
        .repeat_interleave(BLOCK, dim=2)[..., None]
    out = torch.where(pick, _patch_blend(ring, frame_idx, flow),
                      _taps(ring, frame_idx, flow)).to(ring.dtype)
    return (out, paths) if return_paths else out


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("warp_block", "cdfo_warp_block",
                              [_P] * 5 + [_I] * 5 + [_P])


def flow_warp_ring_block(ring, frame_idx, flow, return_paths=False):
    """The warp of ``flow_warp_ring_block_plain``; ring and flow of one
    dtype (float32 or bfloat16), contiguous. With ``return_paths`` also the
    path each block took, bool (B, H/4, W/4), as the kernel reports it."""
    cb.forbid_grad("warp_block", ring, flow)
    _check(ring, frame_idx, flow)
    if not cb.on_card(ring, "warp_block"):
        return flow_warp_ring_block_plain(ring, frame_idx, flow, return_paths)
    cb.check_operands("warp_block", ring, flow)
    if ring.shape[-1] != CHANNELS:
        raise ValueError(f"warp_block takes a ring of {CHANNELS} channels, "
                         f"got {tuple(ring.shape)}")
    if (frame_idx.device != ring.device or frame_idx.dtype.is_floating_point
            or frame_idx.dtype == torch.bool):
        raise TypeError(f"warp_block: frame_idx must be an integer tensor on "
                        f"{ring.device}, got {frame_idx.dtype} on "
                        f"{frame_idx.device}")
    b, h, w, _ = flow.shape
    idx = frame_idx.to(torch.int32).contiguous()
    out = torch.empty((b, h, w, CHANNELS), dtype=ring.dtype,
                      device=ring.device)
    paths = (torch.empty((b, h // BLOCK, w // BLOCK), dtype=torch.uint8,
                         device=ring.device) if return_paths else None)
    cb.launch(_kernel(), "warp_block", ring.device, ring.data_ptr(),
              idx.data_ptr(), flow.data_ptr(), out.data_ptr(),
              paths.data_ptr() if return_paths else None,
              cb.DTYPE_CODES[ring.dtype], ring.shape[0], b, h, w)
    flow_warp_ring_block.launches += 1
    return (out, paths.bool()) if return_paths else out


flow_warp_ring_block.launches = 0
