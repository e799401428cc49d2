"""Per-sequence no-reference quality scores (a copy of
``cdfo_tpu/metrics/video_quality.py``, whose package imports JAX; reference
`metric/cal_VideoLQ.py:495-575`: NIQE / BRISQUE [/ NRQM / PI] means over
PNG frame trees, read through the port's ``data/io.py``)."""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from .brisque import calculate_brisque
from .niqe import calculate_niqe


def default_nrqm_model() -> Optional[str]:
    """NRQM/PI columns appear automatically when a fitted model exists:
    either ``$CDFO_NRQM_MODEL`` or ``cdfo_tpu_torch/metrics/weights/
    NRQM_model.mat`` (produce one with ``fit.fit_nrqm_forest`` +
    ``fit.save_nrqm_model``; the official file is absent upstream too —
    `metric/nrqm.py:1997`)."""
    env = os.environ.get("CDFO_NRQM_MODEL")
    if env and os.path.exists(env):
        return env
    local = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "weights", "NRQM_model.mat")
    return local if os.path.exists(local) else None


def cal_sequence_noref(frames_dir: str, niqe_params: str,
                       brisque_weights: Optional[str] = None,
                       nrqm_params: Optional[str] = None,
                       max_frames: Optional[int] = None,
                       stride: int = 1) -> Dict[str, float]:
    """Mean NIQE (+BRISQUE, +NRQM/PI when their params are given) over a
    PNG frame tree (`metric/cal_VideoLQ.py:495-575` columns)."""
    from ..data.io import read_gray
    from .nrqm import calculate_nrqm

    if nrqm_params is None:
        nrqm_params = default_nrqm_model()
    files = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    if max_frames:
        files = files[:max_frames]
    files = files[::stride]
    niqes, brisques, nrqms = [], [], []
    for f in files:
        img = read_gray(os.path.join(frames_dir, f))
        niqes.append(calculate_niqe(img, niqe_params))
        if brisque_weights:
            brisques.append(calculate_brisque(img, brisque_weights))
        if nrqm_params:
            nrqms.append(calculate_nrqm(img, nrqm_params))
    out = {"niqe": float(np.mean(niqes)), "frames": len(files)}
    if brisques:
        out["brisque"] = float(np.mean(brisques))
    if nrqms:
        out["nrqm"] = float(np.mean(nrqms))
        # PI = 0.5((10-NRQM)+NIQE) per frame-mean (`metric/nrqm.py:2010`)
        out["pi"] = 0.5 * ((10.0 - out["nrqm"]) + out["niqe"])
    return out
