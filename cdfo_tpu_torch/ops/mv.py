"""Motion-vector expansion and edge-frame fixups (host-side, pure numpy).

A copy of ``cdfo_tpu/ops/mv.py``: importing any module of ``cdfo_tpu``
imports JAX, which the port never does.

The HEVC decoder exports one MV field per frame as (H, W, 3) int arrays of
[dy, dx, refPOC_offset]. The pipeline turns the *center* frame's field into 7
per-neighbour pixel flows by linear scaling:

  flow_to_prev1 = [dx, dy] / (-refPOC_offset)   (quarter-pel units)
  neighbours at temporal distance d get flow * d (past) / -d (future)
  final division by 4 (quarter-pel -> pixel) and by 32 (decoder scale).

Frames at sequence edges reuse/zero flows.
"""
from __future__ import annotations

import numpy as np


def generate_input_index(center_index: int, frame_number: int, max_index: int) -> np.ndarray:
    """Clamped sliding window of frame indices."""
    o = np.arange(frame_number) - frame_number // 2 + center_index
    return np.clip(o, 0, max_index)


def mv2mvs(mv: np.ndarray, nframes: int = 7, scale: float = 4.0 * 32.0) -> np.ndarray:
    """Expand one (H, W, 3) [dy, dx, refoff] field to (nframes, H, W, 2) flows.

    Includes the xy swap and nan handling (0/0 -> 0; +-inf from x/0 pass
    through, as in the reference).
    """
    mv_ = mv.astype(np.float32).copy()
    mv_[:, :, [0, 1]] = mv_[:, :, [1, 0]]  # -> [dx, dy, refoff]
    h, w = mv_.shape[:2]
    out = np.zeros((nframes, h, w, 2), dtype=np.float32)
    c = nframes // 2
    with np.errstate(divide="ignore", invalid="ignore"):
        fx = mv_[:, :, 0] / (mv_[:, :, 2] * -1.0)
        fy = mv_[:, :, 1] / (mv_[:, :, 2] * -1.0)
    out[c - 1, :, :, 0] = np.where(~np.isnan(fx), fx, 0)
    out[c - 1, :, :, 1] = np.where(~np.isnan(fy), fy, 0)
    for d in range(2, c + 1):
        out[c - d] = out[c - 1] * float(d)
    for d in range(1, c + 1):
        out[c + d] = out[c - 1] * float(-d)
    return out / scale


def modify_mv_for_end_frames(i: int, mvs: np.ndarray, num_frames: int) -> np.ndarray:
    """In-place edge fixups of a (7, H, W, 2) flow stack for center frame
    ``i`` of a ``num_frames``-frame sequence."""
    max_idx = num_frames
    if i == 0:
        mvs[0] = 0.0
        mvs[1] = 0.0
        mvs[2] = 0.0
    if i == 1:
        mvs[0] = mvs[2]
        mvs[1] = mvs[2]
    if i == 2:
        mvs[0] = mvs[1]
    if i == max_idx - 1:
        mvs[4] = 0.0
        mvs[5] = 0.0
        mvs[6] = 0.0
    if i == max_idx - 2:
        mvs[5] = mvs[4]
        mvs[6] = mvs[4]
    if i == max_idx - 3:
        mvs[6] = mvs[5]
    return mvs


def augment_mv(mv: np.ndarray, hflip: bool, vflip: bool, rot90: bool) -> np.ndarray:
    """Geometric augmentation with MV sign/axis fixups. ``mv``: (F, H, W,
    C>=2) already xy-swapped to [dx, dy, ...]."""
    mv = mv.astype(np.float32).copy()
    if hflip:
        mv = mv[:, :, ::-1, :].copy()
        mv[:, :, :, 0] *= -1
    if vflip:
        mv = mv[:, ::-1, :, :].copy()
        mv[:, :, :, 1] *= -1
    if rot90:
        mv = mv.transpose(0, 2, 1, 3).copy()
        mv[:, :, :, [0, 1]] = mv[:, :, :, [1, 0]]
    return mv
