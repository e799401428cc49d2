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

eval tree:
  <tst_path>{seq}.yuv/00000.png                                  LR frames
  <side_path>{seq}/part_m/00001_M_mask.png  res/00001_res.npy
      unfiltered/00001_unflt.png  mvl0/00001_mvl0.npy  mvl1/00001_mvl1.npy

Images go through ``cv2``, else PIL, else the standard-library codec of
``data/png.py`` (8-bit gray and RGB PNG), so the trainer's data and the eval
tools run on a machine that has neither library.
"""
from __future__ import annotations

import os
from typing import Optional

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


def load_eval_sequence(lr_dir: str, side_dir: str, max_frames: Optional[int] = None):
    """Load one eval sequence into a ``infer.pipeline.SequenceData``.

    Frame 0 priors use index 1 at *window build* time (max(1, i) rule), so
    here we just load every indexed file; missing index-0 prior files fall
    back to index 1 (I-frames have no inter priors).
    """
    from ..infer.pipeline import SequenceData

    files = sorted(f for f in os.listdir(lr_dir) if f.endswith(".png"))
    if max_frames:
        files = files[:max_frames]
    lrs, pms, rms, ufs, mv0s, mv1s = [], [], [], [], [], []
    for i in range(len(files)):
        idx = "%05d" % max(1, i)
        lr = read_gray(os.path.join(lr_dir, files[i])).astype(np.float32) / 255.0
        lrs.append(pad_270_to_272(lr))
        pm = read_gray(os.path.join(side_dir, "part_m", idx + "_M_mask.png"))
        pms.append(pad_270_to_272(pm.astype(np.float32) / 255.0))
        res = np.load(os.path.join(side_dir, "res", idx + "_res.npy"))
        if res.ndim == 3:
            res = res[:, :, 0]
        rms.append(pad_270_to_272(res.astype(np.float32) / 255.0))
        uf = read_gray(os.path.join(side_dir, "unfiltered", idx + "_unflt.png"))
        ufs.append(pad_270_to_272(uf.astype(np.float32) / 255.0))
        mv0s.append(np.load(os.path.join(side_dir, "mvl0", idx + "_mvl0.npy")))
        mv1s.append(np.load(os.path.join(side_dir, "mvl1", idx + "_mvl1.npy")))
    return SequenceData(
        lr=np.stack(lrs), pm=np.stack(pms), rm=np.stack(rms),
        uf=np.stack(ufs), mvl0=np.stack(mv0s), mvl1=np.stack(mv1s))


def make_synthetic_cvcp_tree(root: str, num_seqs: int = 2, frames: int = 32,
                             h: int = 64, w: int = 96, qp: int = 37,
                             cfg: str = "LD", seed: int = 0,
                             structured: bool = False) -> list[str]:
    """Materialise a miniature CVCP-layout tree (the `*_tmp.csv` smoke-test
    trick from `metric/misc/`, but self-contained) for loader tests; the
    JAX package's tree, array for array, for the same arguments. Returns
    the sequence names.

    ``structured=True`` writes LEARNABLE content for convergence soaks
    instead of iid noise: per-sequence static textured HR (smoothed noise
    + oriented sinusoids), LR = MATLAB-bicubic 1/4 downscale + per-frame
    sensor noise, priors derived from the content (unfiltered = blurred
    LR, residual = |LR - blur|); MVs are zero (static content), so a
    model that fuses the 7-frame window and learns the texture statistics
    beats bicubic clearly — pure-noise trees are unlearnable by design.
    """
    r = np.random.RandomState(seed)
    names = []

    def structured_seq(s):
        from scipy.ndimage import gaussian_filter

        hr4 = gaussian_filter(r.rand(4 * h, 4 * w) * 255.0, 6.0)
        yy, xx = np.mgrid[0:4 * h, 0:4 * w]
        for _ in range(4):
            fy, fx = r.uniform(0.02, 0.2, 2)
            ph = r.uniform(0, 6.28)
            hr4 = hr4 + r.uniform(10, 30) * np.sin(fy * yy + fx * xx + ph)
        hr4 = np.clip((hr4 - hr4.min()) / np.ptp(hr4) * 235 + 10, 0, 255)
        from ..metrics.matlab import imresize
        lr_clean = np.clip(imresize(hr4 / 255.0, 0.25), 0, 1) * 255.0
        return hr4, lr_clean
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
        if structured:
            hr4_s, lr_clean_s = structured_seq(s)
        for f in range(frames):
            idx = "%05d" % f
            if structured:
                from scipy.ndimage import gaussian_filter
                hr = hr4_s.astype(np.uint8)
                lr = np.clip(lr_clean_s + r.randn(h, w) * 4.0,
                             0, 255).astype(np.uint8)
                blur = gaussian_filter(lr.astype(np.float32), 1.0)
                uf_img = np.clip(blur, 0, 255).astype(np.uint8)
                res = np.clip(lr.astype(np.int16) - blur.astype(np.int16),
                              -30, 30)
                pm_img = (((np.arange(h)[:, None] // 8
                            + np.arange(w)[None, :] // 8) % 2)
                          .astype(np.uint8) * 255)
                pred = uf_img
                mv = np.zeros((h, w, 3), np.int16)
                mv[..., 2] = -1
            else:
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
