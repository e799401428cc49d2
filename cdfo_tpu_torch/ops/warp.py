"""Flow warping in NHWC (counterpart of ``cdfo_tpu/ops/warp.py``).

Semantics of the reference ``flow_warp``: ``F.grid_sample`` with bilinear
sampling, zeros padding and ``align_corners=True`` at ``grid + flow``, which
with ``align_corners=True`` is the pixel coordinate itself. The gather is
written with explicit index arithmetic, as the JAX package does, so the
coordinates round the same way.

The JAX streaming path gathers from a quad-packed ring (the four bilinear
taps stacked in channels, a TPU gather trick); the port keeps the ring
unpacked, (L, H, W, C), and gathers each tap. Out-of-range taps read zero,
and a sample whose top-left tap lies outside [-1, H-1] x [-1, W-1] is
zeroed whole (the JAX keep-mask).
"""
from __future__ import annotations

import torch

from ..parallel import spatial


def _taps(ring, frame_idx, flow, row0: int = 0):
    """Bilinear zeros-padding sample of ring frames ``frame_idx`` (B,) at
    ``grid + flow``; ring (L, H, W, C), flow (B, Ho, W, 2) (dx, dy) for the
    ring's rows ``row0 .. row0 + Ho`` (all of them by default).
    Returns float32 (B, Ho, W, C)."""
    l, h, w, c = ring.shape
    b, ho = flow.shape[:2]
    f = flow.float()
    dev = ring.device
    sx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] \
        + f[..., 0]
    sy = torch.arange(row0, row0 + ho, dtype=torch.float32,
                      device=dev)[None, :, None] + f[..., 1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx1 = sx - x0
    wy1 = sy - y0
    x0i = x0.long()
    y0i = y0.long()
    keep = ((y0i >= -1) & (y0i <= h - 1) & (x0i >= -1)
            & (x0i <= w - 1)).float()
    flat = ring.reshape(l * h * w, c)
    base = frame_idx.long().reshape(b, 1, 1) * (h * w)
    out = None
    for dy, dx, wt in ((0, 0, keep * (1 - wy1) * (1 - wx1)),
                       (0, 1, keep * (1 - wy1) * wx1),
                       (1, 0, keep * wy1 * (1 - wx1)),
                       (1, 1, keep * wy1 * wx1)):
        yy = y0i + dy
        xx = x0i + dx
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = flat.index_select(0, idx.reshape(-1)).reshape(b, ho, w, c)
        term = v.float() * (wt * inside)[..., None]
        out = term if out is None else out + term
    return out


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``x`` (B, H, W, C) by pixel-unit ``flow`` (B, H, W, 2), last
    dim (dx, dy): bilinear, zeros padding, align_corners=True.

    With H split over ranks (``parallel.spatial``) the taps follow the flow
    anywhere in the frame: the source is gathered whole on every rank and
    sampled at this rank's rows in global coordinates."""
    if x.ndim != 4 or flow.ndim != 4 or flow.shape[-1] != 2:
        raise ValueError(f"bad shapes x={tuple(x.shape)} "
                         f"flow={tuple(flow.shape)}")
    frames = torch.arange(x.shape[0], device=x.device)
    shard = spatial.split()
    if shard is None:
        return _taps(x, frames, flow).to(x.dtype)
    start, _ = shard.bounds_at(x.shape[1])
    source = spatial.gather_rows(x, shard, "warp_gather")
    return _taps(source, frames, flow, start).to(x.dtype)


def flow_warp_ring(ring: torch.Tensor, frame_idx: torch.Tensor,
                   flow: torch.Tensor) -> torch.Tensor:
    """Warp frames picked from an unpacked ring by per-image flows, the
    frame selection composed into the pixel gather (the ring is never
    copied per consumer).

    ring (L, H, W, C); frame_idx (B,) int ring slots; flow (B, H, W, 2).
    Returns (B, H, W, C) in the ring's dtype, equal to
    ``flow_warp(ring[frame_idx], flow)``.
    """
    if ring.ndim != 4 or flow.ndim != 4 or flow.shape[1:3] != ring.shape[1:3]:
        raise ValueError(f"bad shapes ring={tuple(ring.shape)} "
                         f"flow={tuple(flow.shape)}")
    return _taps(ring, frame_idx, flow).to(ring.dtype)


def flow_warp_nearest(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``x`` (B, H, W, C) sampled at the nearest pixel to ``grid + flow``
    (flow (B, H, W, 2), (dx, dy)), the coordinate rounded half to even as
    ``F.grid_sample``'s nearest mode does; zero outside the image."""
    if x.ndim != 4 or flow.ndim != 4 or flow.shape[-1] != 2:
        raise ValueError(f"bad shapes x={tuple(x.shape)} "
                         f"flow={tuple(flow.shape)}")
    b, h, w, c = x.shape
    f = flow.float()
    dev = x.device
    ix = torch.round(torch.arange(w, dtype=torch.float32, device=dev)
                     [None, None, :] + f[..., 0]).long()
    iy = torch.round(torch.arange(h, dtype=torch.float32, device=dev)
                     [None, :, None] + f[..., 1]).long()
    valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    base = torch.arange(b, device=dev).reshape(b, 1, 1) * (h * w)
    idx = base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    out = x.reshape(b * h * w, c).index_select(0, idx.reshape(-1))
    return torch.where(valid[..., None], out.reshape(b, h, w, c),
                       torch.zeros((), dtype=x.dtype, device=dev))
