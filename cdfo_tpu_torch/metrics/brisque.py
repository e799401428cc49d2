"""BRISQUE (numpy, float64; a copy of ``cdfo_tpu/metrics/brisque.py``,
whose package imports JAX; the tests hold the two equal): the reference's
`metric/brisque.py`.

Whole-image MSCN statistics at two scales (GGD + 4 paired-product AGGD fits,
18 features/scale — `:878-894`), MATLAB feature scaling (`:896-915`), RBF
SVM with the official gamma/rho (`:868-876`) and support vectors loaded from
``brisque_svm_weights.pth``.
"""
from __future__ import annotations

import numpy as np

from .matlab import fspecial_gaussian, imfilter, imresize

_GAM = np.arange(0.2, 10.001, 0.001)

_FEATURE_RANGES = np.array([
    [0.338, 10], [0.017204, 0.806612], [0.236, 1.642], [-0.123884, 0.20293],
    [0.000155, 0.712298], [0.001122, 0.470257], [0.244, 1.641],
    [-0.123586, 0.179083], [0.000152, 0.710456], [0.000975, 0.470984],
    [0.249, 1.555], [-0.135687, 0.100858], [0.000174, 0.684173],
    [0.000913, 0.534174], [0.258, 1.561], [-0.143408, 0.100486],
    [0.000179, 0.685696], [0.000888, 0.536508], [0.471, 3.264],
    [0.012809, 0.703171], [0.218, 1.046], [-0.094876, 0.187459],
    [1.5e-05, 0.442057], [0.001272, 0.40803], [0.222, 1.042],
    [-0.115772, 0.162604], [1.6e-05, 0.444362], [0.001374, 0.40243],
    [0.227, 0.996], [-0.117188, 0.098323], [3e-05, 0.531903],
    [0.001122, 0.369589], [0.228, 0.99], [-0.12243, 0.098658],
    [2.8e-05, 0.530092], [0.001118, 0.370399]])


def _ggd_param(x: np.ndarray):
    from scipy.special import gammaln

    r_table = np.exp(gammaln(1.0 / _GAM) + gammaln(3.0 / _GAM)
                     - 2 * gammaln(2.0 / _GAM))
    sigma_sq = np.mean(x ** 2)
    sigma = np.sqrt(sigma_sq)
    e = np.mean(np.abs(x))
    rho = sigma_sq / (e ** 2)
    idx = np.argmin(np.abs(rho - r_table))
    return _GAM[idx], sigma


def _aggd_param_sigma(block: np.ndarray):
    """AGGD fit returning sigmas (the `return_sigma=True` path
    `:172-215`; note the mask-based stds divide by the count of strictly
    negative / positive samples)."""
    from scipy.special import gammaln

    r_gam = np.exp(2 * gammaln(2.0 / _GAM)
                   - (gammaln(1.0 / _GAM) + gammaln(3.0 / _GAM)))
    neg = block[block < 0]
    pos = block[block > 0]
    left_std = np.sqrt(np.sum(neg ** 2) / neg.size) if neg.size else 0.0
    right_std = np.sqrt(np.sum(pos ** 2) / pos.size) if pos.size else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    rhat = np.mean(np.abs(block)) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2)
    idx = np.argmin(np.abs(r_gam - rhatnorm))
    alpha = _GAM[idx]
    return alpha, left_std, right_std


def natural_scene_statistics(luma: np.ndarray) -> np.ndarray:
    from scipy.special import gammaln

    # the reference's 'same' padding is zero-constant (`brisque.py:52`)
    kernel = fspecial_gaussian(7, 7.0 / 6.0)
    mu = imfilter(luma, kernel, "constant")
    sigma = np.sqrt(np.abs(imfilter(luma ** 2, kernel, "constant") - mu ** 2))
    norm = (luma - mu) / (sigma + 1.0)

    alpha, sig = _ggd_param(norm)
    feats = [alpha, sig ** 2]
    for shift in [(0, 1), (1, 0), (1, 1), (-1, 1)]:
        shifted = np.roll(norm, shift, axis=(0, 1))
        a, sl, sr = _aggd_param_sigma(norm * shifted)
        eta = (sr - sl) * np.exp(
            gammaln(2.0 / a) - (gammaln(1.0 / a) + gammaln(3.0 / a)) / 2)
        feats.extend([a, eta, sl ** 2, sr ** 2])
    return np.asarray(feats, np.float64)


def brisque(img: np.ndarray, sv_coef: np.ndarray, sv: np.ndarray,
            gamma: float = 0.05, rho: float = -153.591) -> float:
    """img: (H, W) float64 luma in [0, 255]."""
    feats = []
    x = np.asarray(img, np.float64)
    for _ in range(2):
        feats.append(natural_scene_statistics(x))
        x = imresize(x, 0.5, antialiasing=True)
    feats = np.concatenate(feats)
    scaled = -1 + 2 * (feats - _FEATURE_RANGES[:, 0]) / (
        _FEATURE_RANGES[:, 1] - _FEATURE_RANGES[:, 0])
    dist = np.sum((scaled[:, None] - sv) ** 2, axis=0)
    kernel_features = np.exp(-dist * gamma)
    return float(kernel_features @ sv_coef - rho)


def calculate_brisque(img: np.ndarray, weights_path: str) -> float:
    """img: (H, W) gray or (H, W, 3) RGB, uint8/float [0, 255]."""
    import torch

    sv_coef, sv = torch.load(weights_path, map_location="cpu",
                             weights_only=True)
    sv_coef = sv_coef.numpy().astype(np.float64).reshape(-1)
    sv = sv.numpy().astype(np.float64)
    if sv.shape[0] != 36:
        sv = sv.T
    img = np.asarray(img, np.float64)
    if img.ndim == 3 and img.shape[2] == 3:
        # reference to_y_channel uses RGB->YIQ luma for BRISQUE (`:896-916`
        # of niqe.py); BT.601 luma on RGB
        img = (img / 255.0) @ np.array([0.299, 0.587, 0.114]) * 255.0
    elif img.ndim == 3:
        img = img[:, :, 0]
    return brisque(img, sv_coef, sv)
