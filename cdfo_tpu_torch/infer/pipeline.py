"""Host-side sequence data for streaming inference (pure numpy).

A copy of the framework-free parts of ``cdfo_tpu/infer/pipeline.py``
(importing ``cdfo_tpu`` imports JAX): the sequence container, the
270 -> 272 row padding of LR frames, the 1088 -> 1080 crop of SR frames,
and the seeded synthetic sequence the tests and ``chip_smoke.py`` run.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def pad_lr_frame(img: np.ndarray) -> np.ndarray:
    """(H, W) [0,1] float; 270-row frames get two zero rows appended."""
    if img.shape[0] == 270:
        img = np.concatenate([img, np.zeros((2, img.shape[1]), img.dtype)], axis=0)
    return img


def crop_sr_output(sr: np.ndarray) -> np.ndarray:
    """(H, W) SR output; undo the LR padding at 4x scale."""
    if sr.shape[0] == 1088:
        return sr[:-8]
    if sr.shape[0] == 736:
        return sr[:-16]
    return sr


@dataclasses.dataclass
class SequenceData:
    """Host-side arrays for one sequence.

    lr, pm, rm, uf: (T, H, W) float32 in [0,1] (lr/pm already padded to a
    multiple of 8 rows; uf comes at 272 rows natively in the CVCP layout).
    mvl0, mvl1: (T, H_mv, W_mv, 3) raw decoder fields ([dy, dx, refoff]).
    """

    lr: np.ndarray
    pm: np.ndarray
    rm: np.ndarray
    uf: np.ndarray
    mvl0: np.ndarray
    mvl1: np.ndarray

    @property
    def num_frames(self) -> int:
        return self.lr.shape[0]


def synthetic_sequence(t: int = 12, h: int = 64, w: int = 96,
                       seed: int = 0) -> SequenceData:
    """Small random sequence for tests and smoke runs; the same seed gives
    the same arrays as ``cdfo_tpu.infer.pipeline.synthetic_sequence``."""
    r = np.random.RandomState(seed)
    lr = r.rand(t, h, w).astype(np.float32)
    pm = (r.rand(t, h, w) > 0.5).astype(np.float32)
    rm = (r.rand(t, h, w).astype(np.float32) - 0.5) * 0.2
    uf = np.clip(lr + r.randn(t, h, w).astype(np.float32) * 0.02, 0, 1)
    # MV maps are piecewise constant over 4x4 pixel blocks, like the real
    # coding priors (HEVC motion vectors live on >=4x4 luma partitions)
    hb, wb = -(-h // 4), -(-w // 4)
    mv = np.zeros((t, h, w, 3), np.float32)
    for ax in (0, 1):
        blk = r.randint(-16, 16, (t, hb, wb)).astype(np.float32)
        mv[..., ax] = np.repeat(np.repeat(blk, 4, axis=1), 4,
                                axis=2)[:, :h, :w]
    mv[..., 2] = -1
    return SequenceData(lr, pm, rm, uf, mv, mv.copy())
