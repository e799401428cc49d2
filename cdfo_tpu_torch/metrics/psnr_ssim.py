"""MATLAB-compatible PSNR / SSIM / tOF (reference `metric/psnr_ssim.py`): a
copy of the numpy parts of ``cdfo_tpu/metrics/psnr_ssim.py``, whose package
imports JAX.

Protocol pinned by the reference eval (`metric/psnr_ssim.py:446-488`):
Y-channel (BT.601), crop_border=4, MATLAB-style SSIM (11x11 gaussian,
sigma=1.5, interior-only), per-sequence frame mean, float64 math.

Where neither ``cv2`` nor PIL is installed, PNGs are read through
``data/io.py``'s standard-library codec and SSIM's filter is scipy's; tOF
(Farneback optical flow) needs ``cv2`` and raises without it.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..data import png
from ..data.io import Image, cv2, read_gray


# --------------------------------------------------------------------------
# colour conversions (BT.601, MATLAB-compatible — `metric/psnr_ssim.py:8-273`)
# --------------------------------------------------------------------------

def _convert_input_type_range(img: np.ndarray) -> np.ndarray:
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.uint8:
        img /= 255.0
    elif img_type not in (np.float32, np.float64):
        raise TypeError(f"img type should be np.float32 or np.uint8, got {img_type}")
    return img


def _convert_output_type_range(img: np.ndarray, dst_type) -> np.ndarray:
    if dst_type not in (np.uint8, np.float32):
        raise TypeError(f"dst_type should be np.float32 or np.uint8, got {dst_type}")
    if dst_type == np.uint8:
        img = img.round()
    else:
        img /= 255.0
    return img.astype(dst_type)


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, [65.481, 128.553, 24.966]) + 16.0
    else:
        out = np.matmul(img, [[65.481, -37.797, 112.0],
                              [128.553, -74.203, -93.786],
                              [24.966, 112.0, -18.214]]) + [16, 128, 128]
    return _convert_output_type_range(out, img_type)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, [24.966, 128.553, 65.481]) + 16.0
    else:
        out = np.matmul(img, [[24.966, 112.0, -18.214],
                              [128.553, -74.203, -93.786],
                              [65.481, -37.797, 112.0]]) + [16, 128, 128]
    return _convert_output_type_range(out, img_type)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    out = np.matmul(img, [[0.00456621, 0.00456621, 0.00456621],
                          [0, -0.00153632, 0.00791071],
                          [0.00625893, -0.00318811, 0]]) * 255.0 + \
        [-222.921, 135.576, -276.836]
    return _convert_output_type_range(out, img_type)


def ycbcr2bgr(img: np.ndarray) -> np.ndarray:
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    out = np.matmul(img, [[0.00456621, 0.00456621, 0.00456621],
                          [0.00791071, -0.00153632, 0],
                          [0, -0.00318811, 0.00625893]]) * 255.0 + \
        [-276.836, 135.576, -222.921]
    return _convert_output_type_range(out, img_type)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """[0,255] image -> Y channel in [0,255] float (no rounding).
    Single-channel inputs pass through (`metric/psnr_ssim.py:201-214`)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0


# --------------------------------------------------------------------------
# PSNR / SSIM
# --------------------------------------------------------------------------

def calculate_psnr(img1: np.ndarray, img2: np.ndarray, crop_border: int,
                   input_order: str = "HWC", test_y_channel: bool = False) -> float:
    assert img1.shape == img2.shape, f"shapes differ: {img1.shape} vs {img2.shape}"
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img1 = to_y_channel(img1)
        img2 = to_y_channel(img2)
    mse = np.mean((img1.astype(np.float64) - img2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # identical to cv2.getGaussianKernel outer product
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k)


def _filter2d_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Correlation, interior-only (equivalent to cv2.filter2D + [5:-5] crop)."""
    if cv2 is not None:
        return cv2.filter2D(img, -1, window)[5:-5, 5:-5]
    from scipy.signal import convolve2d
    # symmetric window: correlation == convolution
    return convolve2d(img, window, mode="valid")


def _ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window(11, 1.5)
    mu1 = _filter2d_valid(img1, window)
    mu2 = _filter2d_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2d_valid(img1 ** 2, window) - mu1_sq
    sigma2_sq = _filter2d_valid(img2 ** 2, window) - mu2_sq
    sigma12 = _filter2d_valid(img1 * img2, window) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray, crop_border: int,
                   input_order: str = "HWC", test_y_channel: bool = False) -> float:
    assert img1.shape == img2.shape, f"shapes differ: {img1.shape} vs {img2.shape}"
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img1 = to_y_channel(img1)
        img2 = to_y_channel(img2)
    # reference feeds the (H, W, 1) array whole (`metric/psnr_ssim.py:394-399`)
    return _ssim(np.squeeze(img1, -1) if img1.ndim == 3 and img1.shape[2] == 1 else img1,
                 np.squeeze(img2, -1) if img2.ndim == 3 and img2.shape[2] == 1 else img2)


def calculate_tof(true_cur, pred_cur, true_pre, pred_pre) -> float:
    """Temporal optical-flow EPE via Farneback (`metric/psnr_ssim.py:404-421`).

    Colour inputs are converted to grayscale first — the reference
    comments its RGB2GRAY lines out (`:406-409`) yet its REDS/Vid4
    drivers feed it 3-channel PIL arrays, which Farneback rejects
    (8-bit single-channel only): broken as shipped, repaired here with
    the exact conversion the reference disabled."""
    if cv2 is None:
        raise RuntimeError("cv2 required for tOF")

    def _gray(img):
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[2] == 3:
            return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        return img

    true_cur, pred_cur, true_pre, pred_pre = map(
        _gray, (true_cur, pred_cur, true_pre, pred_pre))
    true_of = cv2.calcOpticalFlowFarneback(true_pre, true_cur, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    pred_of = cv2.calcOpticalFlowFarneback(pred_pre, pred_cur, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    diff = true_of - pred_of
    return float(np.mean(np.sqrt(np.sum(diff ** 2, axis=-1))))


# --------------------------------------------------------------------------
# sequence drivers
# --------------------------------------------------------------------------

def cal_psnr_ssim(save_path: str, res_vid_name: Sequence[str],
                  gt_vid_name: Sequence[str], gt_path: str,
                  crop_border: int = 4, num_frames: int | None = None):
    """Per-sequence mean PSNR/SSIM over PNG trees, reference protocol
    (`metric/psnr_ssim.py:446-488`; frame count parsed from the sequence
    name's `_NNNF` suffix unless given)."""
    results = []
    for res_f, gt_f in zip(res_vid_name, gt_vid_name):
        frames = num_frames if num_frames is not None else int(res_f[-8:-5])
        psnr = ssim = 0.0
        for i in range(frames):
            idx = "%05d" % i
            res = read_gray(os.path.join(save_path, res_f, idx + ".png"))
            gt = read_gray(os.path.join(gt_path, gt_f, idx + ".png"))
            mh = min(res.shape[0], gt.shape[0])
            mw = min(res.shape[1], gt.shape[1])
            res = res[:mh, :mw, None].astype(np.float64)
            gt = gt[:mh, :mw, None].astype(np.float64)
            psnr += calculate_psnr(res, gt, crop_border, test_y_channel=True)
            ssim += calculate_ssim(res, gt, crop_border, test_y_channel=True)
        results.append((res_f, psnr / frames, ssim / frames))
    if len(results) == 1:
        return results[0][1], results[0][2]
    return results


def cal_psnr_ssim_tof(save_path: str, res_vid_name: Sequence[str],
                      gt_vid_name: Sequence[str], gt_path: str,
                      crop_border: int = 4, num_frames: int | None = None):
    """PSNR/SSIM/tOF sequence driver (`metric/psnr_ssim.py:490-652`
    dataset drivers): tOF is the Farneback EPE between consecutive GT/SR
    frame pairs, starting from the second frame."""
    results = []
    for res_f, gt_f in zip(res_vid_name, gt_vid_name):
        frames = num_frames if num_frames is not None else int(res_f[-8:-5])
        psnr = ssim = tof = 0.0
        prev_res = prev_gt = None
        for i in range(frames):
            idx = "%05d" % i
            res = read_gray(os.path.join(save_path, res_f, idx + ".png"))
            gt = read_gray(os.path.join(gt_path, gt_f, idx + ".png"))
            mh = min(res.shape[0], gt.shape[0])
            mw = min(res.shape[1], gt.shape[1])
            res = res[:mh, :mw]
            gt = gt[:mh, :mw]
            psnr += calculate_psnr(res[..., None].astype(np.float64),
                                   gt[..., None].astype(np.float64),
                                   crop_border, test_y_channel=True)
            ssim += calculate_ssim(res[..., None].astype(np.float64),
                                   gt[..., None].astype(np.float64),
                                   crop_border, test_y_channel=True)
            if prev_res is not None:
                tof += calculate_tof(gt, res, prev_gt, prev_res)
            prev_res, prev_gt = res, gt
        results.append((res_f, psnr / frames, ssim / frames,
                        tof / max(frames - 1, 1)))
    return results


def _read_pil_order(path: str) -> np.ndarray:
    """Read a PNG exactly as the reference dataset drivers do
    (``np.array(Image.open(...))`` — `metric/psnr_ssim.py:505-510`):
    grayscale files come back (H, W) uint8, colour files (H, W, 3) in
    **RGB** order. Note the reference then feeds RGB arrays through a
    BGR-assuming ``to_y_channel`` (`:211-213`) — Y is computed with the
    R/B coefficients swapped on colour datasets. We reproduce that
    behaviour bit-for-bit so scores stay comparable."""
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        # fast path only for the shapes where cv2 and PIL provably agree:
        # 8-bit gray or 8-bit BGR. 16-bit and alpha PNGs fall through to
        # PIL (cv2 returns uint16 / BGRA, which a channel flip alone does
        # not reconcile with PIL's RGBA — ADVICE r4).
        if img is not None and img.dtype == np.uint8 and (
                img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
            if img.ndim == 3:
                img = img[..., ::-1]  # BGR -> RGB, PIL order
            return img
    if Image is not None:
        return np.array(Image.open(path))
    return png.read_png(path)


def _tof_driver(save_path: str, res_vid_name: Sequence[str],
                gt_vid_name: Sequence[str], gt_path: str,
                frames_for, idx_fmt: str, one_video: bool):
    """Shared body of the three reference dataset drivers
    (`metric/psnr_ssim.py:490-652`): per-frame PSNR/SSIM/tOF with the
    frame-0 tOF term computed against itself (zero) and INCLUDED in the
    frames-count mean — unlike :func:`cal_psnr_ssim_tof`, which starts at
    the second frame and divides by frames-1. Returns the reference's
    6-tuple ``(psnr_str, ssim_str, tof_str, sum_psnr, sum_ssim, sum_tof)``
    when ``one_video`` (the only mode the reference ever uses; its
    multi-video tail is dead code). The reference's REDS/Vid4 drivers
    accumulate ``ssim`` into the tOF running sum (`:580,644` —
    ``seq_ave_tOF += ssim / frames``); that accumulator is dead under
    ``one_video`` and we keep the accounting correct."""
    sum_psnr = sum_ssim = sum_tof = 0.0
    out = None
    for res_f, gt_f in zip(res_vid_name, gt_vid_name):
        frames = frames_for(res_f)
        psnr = ssim = tof = 0.0
        prev_res = prev_gt = None
        for i in range(frames):
            idx = idx_fmt % i
            res = _read_pil_order(os.path.join(save_path, res_f, idx + ".png"))
            gt = _read_pil_order(os.path.join(gt_path, gt_f, idx + ".png"))
            if prev_res is None:
                prev_res, prev_gt = res, gt
            psnr += calculate_psnr(res, gt, 4, test_y_channel=True)
            ssim += calculate_ssim(res, gt, 4, test_y_channel=True)
            tof += calculate_tof(gt, res, prev_gt, prev_res)
            prev_res, prev_gt = res, gt
        sum_psnr += psnr / frames
        sum_ssim += ssim / frames
        sum_tof += tof / frames
        out = ("%.3f" % (psnr / frames), "%.5f" % (ssim / frames),
               "%.5f" % (tof / frames), sum_psnr, sum_ssim, sum_tof)
        if one_video:
            return out
    return out


def cal_psnr_ssim_tof_cvcp(save_path, res_vid_name, gt_vid_name, gt_path,
                           one_video: bool = True):
    """CVCP driver (`metric/psnr_ssim.py:490`): frame count parsed from the
    sequence name's ``_NNNF`` suffix, ``%05d`` frame naming."""
    return _tof_driver(save_path, res_vid_name, gt_vid_name, gt_path,
                       lambda res_f: int(res_f[-8:-5]), "%05d", one_video)


def cal_psnr_ssim_tof_reds(save_path, res_vid_name, gt_vid_name, gt_path,
                           one_video: bool = True):
    """REDS driver (`metric/psnr_ssim.py:542`): fixed 100 frames,
    ``%08d`` frame naming."""
    return _tof_driver(save_path, res_vid_name, gt_vid_name, gt_path,
                       lambda res_f: 100, "%08d", one_video)


_VID4_FRAMES = {"calendar": 41, "city": 34, "foliage": 49, "walk": 47}


def cal_psnr_ssim_tof_vid4(save_path, res_vid_name, gt_vid_name, gt_path,
                           one_video: bool = True):
    """Vid4 driver (`metric/psnr_ssim.py:593`): per-sequence frame counts
    (calendar 41 / city 34 / foliage 49 / walk 47, else 100), ``%08d``
    frame naming."""
    return _tof_driver(save_path, res_vid_name, gt_vid_name, gt_path,
                       lambda res_f: _VID4_FRAMES.get(res_f, 100), "%08d",
                       one_video)
