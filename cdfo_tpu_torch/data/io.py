"""Filesystem IO for the CVCP data layout (``cdfo_tpu/data/io.py``).

Layout (reference `opt/data_LD_bi.py:22-28,64-131`):

training tree:
  <root>/Decoded_LR/{cfg}/QP{qp}/{cfg}_{seq}_32F_QP{qp}.yuv/00000.png  LR Y
  <root>/Uncompressed_HR/{seq}/00000.png                              HR Y
  <root>/Coding_Priors/{cfg}/QP{qp}/{cfg}_{seq}_32F_QP{qp}.priors/
      MV_l0/00000_mvl0.npy  MV_l1/00000_mvl1.npy  Residue/00000_res.npy
      Partition_Map/00000_M_mask.png  Prediction_Signal/00000_pred.png
  <root>/pred_unfiltered_{cfg}/QP{qp}/{cfg}_{seq}_32F_QP{qp}.priors/
      pred_unfiltered/00000_unflt.png
  <root>/sequences_list.csv

Images go through ``cv2``, else PIL, else the standard-library codec of
``data/png.py`` (8-bit gray and RGB PNG), so the trainer's data runs on a
machine that has neither library. The eval sequence loader waits for the
eval path (ROADMAP Queue 1, item 1.3).
"""
from __future__ import annotations

import os

import numpy as np

from . import png

try:
    import cv2
except ImportError:
    cv2 = None
try:
    from PIL import Image
except ImportError:
    Image = None


def read_gray(path: str) -> np.ndarray:
    """An image file as (H, W) uint8 luma."""
    if cv2 is not None:
        img = cv2.imread(path, 0)
        if img is None:
            raise FileNotFoundError(path)
        return img
    if Image is not None:
        return np.array(Image.open(path).convert("L"))
    img = png.read_png(path)
    return img if img.ndim == 2 else png.rgb_to_gray(img)


def write_gray(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 -> a gray PNG (its directory made)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if cv2 is not None:
        cv2.imwrite(path, img)
    elif Image is not None:
        Image.fromarray(img).save(path)
    else:
        png.write_png(path, img)


def pad_270_to_272(img: np.ndarray) -> np.ndarray:
    """Append two zero rows (`test_LD_37.py:24-26`)."""
    if img.shape[0] == 270:
        img = np.concatenate(
            [img, np.zeros((2,) + img.shape[1:], img.dtype)], axis=0)
    return img


def make_synthetic_cvcp_tree(root: str, num_seqs: int = 2, frames: int = 32,
                             h: int = 64, w: int = 96, qp: int = 37,
                             cfg: str = "LD", seed: int = 0,
                             structured: bool = False) -> list[str]:
    """A miniature CVCP-layout tree of iid noise (the JAX tree's arrays for
    the same arguments), for loader tests and smoke runs; returns the
    sequence names. ``structured=True`` (learnable content) needs the
    MATLAB-bicubic resize of ``cdfo_tpu/metrics/matlab.py``, which is not
    ported (ROADMAP Queue 1, item 1.5)."""
    if structured:
        raise NotImplementedError(
            "structured=True needs metrics/matlab.py's imresize, which waits "
            "for the int8 budget's trainer script (ROADMAP Queue 1, item "
            "1.5)")
    r = np.random.RandomState(seed)
    names = []
    for s in range(num_seqs):
        seq = f"synth{s:03d}_{w}x{h}"
        names.append(seq)
        lr_dir = os.path.join(root, "Decoded_LR", cfg, f"QP{qp}",
                              f"{cfg}_{seq}_32F_QP{qp}.yuv")
        hr_dir = os.path.join(root, "Uncompressed_HR", seq)
        pri = os.path.join(root, "Coding_Priors", cfg, f"QP{qp}",
                           f"{cfg}_{seq}_32F_QP{qp}.priors")
        unf = os.path.join(root, f"pred_unfiltered_{cfg}", f"QP{qp}",
                           f"{cfg}_{seq}_32F_QP{qp}.priors", "pred_unfiltered")
        for d in [lr_dir, hr_dir, os.path.join(pri, "MV_l0"),
                  os.path.join(pri, "MV_l1"), os.path.join(pri, "Residue"),
                  os.path.join(pri, "Partition_Map"),
                  os.path.join(pri, "Prediction_Signal"), unf]:
            os.makedirs(d, exist_ok=True)
        for f in range(frames):
            idx = "%05d" % f
            lr = r.randint(0, 255, (h, w), dtype=np.uint8)
            hr = r.randint(0, 255, (h * 4, w * 4), dtype=np.uint8)
            mv = np.zeros((h, w, 3), np.int16)
            mv[..., 0] = r.randint(-32, 32, (h, w))
            mv[..., 1] = r.randint(-32, 32, (h, w))
            mv[..., 2] = -1
            res = r.randint(-30, 30, (h, w)).astype(np.int16)
            pm_img = (r.rand(h, w) > 0.5).astype(np.uint8) * 255
            pred = r.randint(0, 255, (h, w), dtype=np.uint8)
            uf_img = r.randint(0, 255, (h, w), dtype=np.uint8)
            write_gray(os.path.join(lr_dir, idx + ".png"), lr)
            write_gray(os.path.join(hr_dir, idx + ".png"), hr)
            np.save(os.path.join(pri, "MV_l0", idx + "_mvl0.npy"), mv)
            np.save(os.path.join(pri, "MV_l1", idx + "_mvl1.npy"), mv)
            np.save(os.path.join(pri, "Residue", idx + "_res.npy"), res)
            write_gray(os.path.join(pri, "Partition_Map", idx + "_M_mask.png"),
                       pm_img)
            write_gray(os.path.join(pri, "Prediction_Signal", idx + "_pred.png"),
                       pred)
            write_gray(os.path.join(unf, idx + "_unflt.png"), uf_img)
    with open(os.path.join(root, "sequences_list.csv"), "w") as f:
        f.write("name\n")
        for n in names:
            f.write(n + "\n")
    return names
