"""NRQM (Ma et al. "Learning a No-Reference Quality Metric for Single-Image
Super-Resolution") and the Perceptual Index.

A numpy copy of ``cdfo_tpu/metrics/nrqm.py`` (whose package imports JAX;
the tests hold the two equal): a reimplementation of the reference's
2k-line torch NRQM (`metric/nrqm.py`) in vectorised numpy/scipy:

  f1 (18) — per Gaussian-pyramid level: generalized-gaussian shape and
     coefficient-of-variation statistics of 7x7 block DCTs plus oriented
     DCT energy variation (`:1592-1737`);
  f2 (45) — complex steerable pyramid (2 scales x 6 orientations,
     `SCFpyr_PyTorch` `:1149-1318`), divisive normalisation over a
     spatial/parent/orientation neighbourhood (`:1739-1806`), GGD shape
     fits, cross-scale fits, and SSIM-cs structural correlations
     (`:1808-1846`);
  f3 (75) — singular values of 5x5 distinct-block matrices per level.

The three random forests + linear blend (`:1847-1926`) evaluate when the
caller supplies the official ``NRQM_model.mat`` (absent from the reference
tree too — its loader points at a hard-coded cluster path, `:1997`).

PI = 0.5 * ((10 - NRQM) + NIQE)  (`metric/nrqm.py:2010-2027`).
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.fft
import scipy.io

from .matlab import fspecial_gaussian, imresize

# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def _exact_pad(img: np.ndarray, kernel: int, stride: int) -> np.ndarray:
    """Tensorflow-style 'same' zero padding (`metric/nrqm.py:884-904`)."""
    h, w = img.shape
    h2, w2 = math.ceil(h / stride), math.ceil(w / stride)
    pad_row = (h2 - 1) * stride + kernel - h
    pad_col = (w2 - 1) * stride + kernel - w
    return np.pad(img, ((pad_row // 2, pad_row - pad_row // 2),
                        (pad_col // 2, pad_col - pad_col // 2)))


def _patches(img: np.ndarray, kernel: int, stride: int) -> np.ndarray:
    """'same'-padded sliding blocks -> (num, kernel, kernel)."""
    x = _exact_pad(img, kernel, stride)
    from numpy.lib.stride_tricks import sliding_window_view
    win = sliding_window_view(x, (kernel, kernel))[::stride, ::stride]
    return win.reshape(-1, kernel, kernel)


def gauss_pyramid(img: np.ndarray, scale: int = 2) -> List[np.ndarray]:
    """3x3 sigma-0.5 gaussian + [1::2, 1::2] subsample (`:1592-1603`)."""
    kernel = fspecial_gaussian(3, 0.5)
    pyr = [img]
    x = img
    from numpy.lib.stride_tricks import sliding_window_view
    for _ in range(scale):
        xp = _exact_pad(x, 3, 1)
        win = sliding_window_view(xp, (3, 3))
        x = np.einsum("hwij,ij->hw", win, kernel)
        x = x[1::2, 1::2]
        pyr.append(x)
    return pyr


def _dct2d(blocks: np.ndarray) -> np.ndarray:
    """Orthonormal 2-D DCT-II over the last two axes."""
    v = scipy.fft.dct(blocks, axis=-1, norm="ortho")
    return scipy.fft.dct(v, axis=-2, norm="ortho")


_GAMMA_RANGE = np.arange(0.03, 10 + 0.001, 0.001)
_R_TABLE = np.exp(
    scipy.special.gammaln(1.0 / _GAMMA_RANGE)
    + scipy.special.gammaln(3.0 / _GAMMA_RANGE)
    - 2 * scipy.special.gammaln(2.0 / _GAMMA_RANGE))


def gamma_gen_gauss(x: np.ndarray) -> np.ndarray:
    """GGD shape parameter per row via the rho lookup (`:1615-1646`)."""
    eps = 1e-7
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, ddof=1, keepdims=True)
    mean_abs = np.abs(x - mean).mean(axis=-1, keepdims=True) ** 2
    rho = var / (mean_abs + eps)
    idx = np.abs(rho - _R_TABLE[None, :]).argmin(axis=-1)
    return _GAMMA_RANGE[idx]


def _var_gen_gauss(x: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    std = np.abs(x).std(axis=-1, ddof=1)
    mean = np.abs(x).mean(axis=-1)
    return std / (mean + eps)


# ---------------------------------------------------------------------------
# f1: block-DCT features
# ---------------------------------------------------------------------------


def block_dct_features(img: np.ndarray) -> np.ndarray:
    """6 frequency-statistics features of one pyramid level (`:1710-1737`)."""
    blocks = _patches(img, 7, 3)
    d = _dct2d(blocks)
    flat = d.reshape(d.shape[0], -1)[:, 1:]

    g = np.sort(gamma_gen_gauss(flat))
    p10_g = g[: math.ceil(0.1 * g.shape[-1]) + 1].mean()
    p100_g = g.mean()

    cv = np.sort(_var_gen_gauss(flat))
    p10_cv = cv[math.floor(0.9 * cv.shape[-1]):].mean()
    p100_cv = cv.mean()

    # oriented frequency energy variation (`:1668-1708`)
    eps = 1e-8
    feat1 = np.concatenate(
        [d[..., 0, 1:], d[..., 1, 2:], d[..., 2, 4:], d[..., 3, 5:]], axis=-1)
    feat2 = np.concatenate(
        [d[..., 1, 1:2], d[..., 2, 2:4], d[..., 3, 2:5], d[..., 4, 3:],
         d[..., 5, 4:], d[..., 6, 4:]], axis=-1)
    feat3 = np.concatenate(
        [d[..., 1:, 0], d[..., 2:, 1], d[..., 4:, 2], d[..., 5:, 3]], axis=-1)
    gs = np.stack([_var_gen_gauss(feat1, eps), _var_gen_gauss(feat2, eps),
                   _var_gen_gauss(feat3, eps)], axis=-1)
    rho = np.sort(gs.var(axis=-1, ddof=1))
    p10_o = rho[math.floor(0.9 * rho.shape[-1]):].mean()
    p100_o = rho.mean()

    return np.array([p10_g, p100_g, p10_cv, p100_cv, p10_o, p100_o])


# ---------------------------------------------------------------------------
# complex steerable pyramid (`SCFpyr_PyTorch`, `:1149-1318`)
# ---------------------------------------------------------------------------


def _prepare_grid(m: int, n: int):
    x = np.linspace(-(m // 2) / (m / 2),
                    (m // 2) / (m / 2) - (1 - m % 2) * 2 / m, num=m)
    y = np.linspace(-(n // 2) / (n / 2),
                    (n // 2) / (n / 2) - (1 - n % 2) * 2 / n, num=n)
    xv, yv = np.meshgrid(y, x)
    angle = np.arctan2(yv, xv)
    rad = np.sqrt(xv ** 2 + yv ** 2)
    rad[m // 2][n // 2] = rad[m // 2][n // 2 - 1]
    return np.log2(rad), angle


def _rcos_fn(width: float, position: float):
    N = 256
    X = np.pi * np.arange(-N - 1, 2) / 2 / N
    Y = np.cos(X) ** 2
    Y[0] = Y[1]
    Y[N + 2] = Y[N + 1]
    X = position + 2 * width / np.pi * (X + np.pi / 4)
    return X, Y


def _point_op(im: np.ndarray, Y: np.ndarray, X: np.ndarray) -> np.ndarray:
    return np.interp(im.flatten(), X, Y).reshape(im.shape)


def scf_pyramid(img: np.ndarray, height: int = 2, nbands: int = 6):
    """Complex steerable pyramid of a single (H, W) image.

    Returns [hi0 (H,W) real, [band0..band{n-1}] complex per scale...,
    lowpass real] — same structure as the reference's ``build``.

    The masks are computed in float32 (matching the reference's
    ``torch.from_numpy(...).float()`` casts) so oracle tests agree to
    float32 precision.
    """
    h, w = img.shape
    if height > int(np.floor(np.log2(min(h, w))) - 2):
        raise RuntimeError(f"Cannot build {height} levels, image too small.")
    lutsize = 1024
    Xcosn = np.pi * np.arange(-(2 * lutsize + 1), lutsize + 2) / lutsize
    alpha = (Xcosn + np.pi) % (2 * np.pi) - np.pi
    complex_fact = np.power(complex(0, -1), nbands - 1)

    log_rad, angle = _prepare_grid(h, w)
    Xrcos, Yrcos = _rcos_fn(1, -0.5)
    Yrcos = np.sqrt(Yrcos)
    YIrcos = np.sqrt(1 - Yrcos ** 2)
    lo0mask = _point_op(log_rad, YIrcos, Xrcos).astype(np.float32)
    hi0mask = _point_op(log_rad, Yrcos, Xrcos).astype(np.float32)

    dft = np.fft.fftshift(np.fft.fft2(img))
    lodft = dft * lo0mask

    def build_levels(lodft, log_rad, angle, Xrcos, Yrcos, height):
        if height <= 0:
            lo0 = np.fft.ifft2(np.fft.ifftshift(lodft))
            return [lo0.real]
        Xrcos = Xrcos - np.log2(2)
        himask = _point_op(log_rad, Yrcos, Xrcos).astype(np.float32)
        order = nbands - 1
        const = (2 ** (2 * order)) * (math.factorial(order) ** 2) / (
            nbands * math.factorial(2 * order))
        Ycosn = (2 * np.sqrt(const) * np.power(np.cos(Xcosn), order)
                 * (np.abs(alpha) < np.pi / 2))
        orientations = []
        for b in range(nbands):
            anglemask = _point_op(
                angle, Ycosn, Xcosn + np.pi * b / nbands).astype(np.float32)
            banddft = lodft * anglemask * himask * complex_fact
            band = np.fft.ifft2(np.fft.ifftshift(banddft))
            orientations.append(band)
        dims = np.array(lodft.shape)
        start = (np.ceil((dims + 0.5) / 2)
                 - np.ceil((np.ceil((dims - 0.5) / 2) + 0.5) / 2)).astype(int)
        end = (start + np.ceil((dims - 0.5) / 2)).astype(int)
        log_rad = log_rad[start[0]:end[0], start[1]:end[1]]
        angle = angle[start[0]:end[0], start[1]:end[1]]
        lodft = lodft[start[0]:end[0], start[1]:end[1]]
        YIrcos = np.abs(np.sqrt(1 - Yrcos ** 2))
        lomask = _point_op(log_rad, YIrcos, Xrcos).astype(np.float32)
        lodft = lodft * lomask
        coeff = build_levels(lodft, log_rad, angle, Xrcos, Yrcos, height - 1)
        coeff.insert(0, orientations)
        return coeff

    coeff = build_levels(lodft, log_rad, angle, Xrcos, Yrcos, height)
    hi0 = np.fft.ifft2(np.fft.ifftshift(dft * hi0mask))
    coeff.insert(0, hi0.real)
    return coeff


# ---------------------------------------------------------------------------
# f2: GSM features
# ---------------------------------------------------------------------------


def _imresize_to(img: np.ndarray, sizes: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape
    if (h, w) == tuple(sizes):
        return img.copy()
    assert sizes[0] % h == 0 and sizes[1] % w == 0, (sizes, img.shape)
    return imresize(img, sizes[0] / h, antialiasing=False)


def norm_sender_normalized(pyr: Sequence[np.ndarray], num_scale: int = 2,
                           num_bands: int = 6, blksz: int = 3,
                           eps: float = 1e-12) -> List[np.ndarray]:
    """Divisive normalisation over a spatial + parent + orientation
    neighbourhood (`:1739-1806`)."""
    border = blksz // 2
    guardband = 16
    from numpy.lib.stride_tricks import sliding_window_view
    subbands = []
    for si in range(num_scale):
        for bi in range(num_bands):
            idx = si * num_bands + bi
            band = pyr[idx]
            N = blksz ** 2
            win = sliding_window_view(band, (3, 3))
            hw = win.shape[0] * win.shape[1]
            tmp = win.reshape(hw, 9)
            cols = [tmp]
            parent_idx = idx + num_bands
            if parent_idx < len(pyr):
                par = _imresize_to(pyr[parent_idx], band.shape)
                cols.append(par[border:-border, border:-border]
                            .reshape(hw, 1))
                N += 1
            for ni in range(num_bands):
                if ni != bi:
                    nei = pyr[si * num_bands + ni]
                    cols.append(nei[border:-border, border:-border]
                                .reshape(hw, 1))
            tmp = np.concatenate(cols, axis=-1)

            C_x = tmp.T @ tmp / tmp.shape[0]
            L, Q = np.linalg.eigh(C_x)
            L_pos = L * (L > 0)
            s = L_pos.sum()
            L = L_pos * L.sum() / (s + (s == 0))
            C_x = Q @ np.diag(L) @ Q.T

            o_c = band[border:-border, border:-border]
            h, w = o_c.shape
            o_c = o_c.reshape(hw)
            o_c = o_c - o_c.mean()

            sol = np.linalg.lstsq(C_x.T, tmp.T, rcond=None)[0].T
            z = np.sqrt((sol * tmp / N).sum(axis=1))
            mask = z != 0
            g_c = o_c * mask / (z * mask + eps)
            g_c = g_c.reshape(h, w)
            gb = int(guardband / (2 ** si))
            g_c = g_c[gb:-gb, gb:-gb]
            subbands.append(g_c - g_c.mean())
    return subbands


def _ssim_cs(x: np.ndarray, y: np.ndarray, data_range: float = 255.0) -> float:
    """Mean contrast-structure term of SSIM, 'valid' windows (`:120-168`)."""
    win = fspecial_gaussian(11, 1.5)
    c2 = (0.03 * data_range) ** 2
    from scipy.signal import correlate2d

    def f(t):
        return correlate2d(t, win, mode="valid")

    mu1, mu2 = f(x), f(y)
    s1 = f(x * x) - mu1 * mu1
    s2 = f(y * y) - mu2 * mu2
    s12 = f(x * y) - mu1 * mu2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    return float(np.maximum(cs, 0.0).mean())


def global_gsm_features(img: np.ndarray) -> np.ndarray:
    """45 GSM features of the (H, W) [0,255] image (`:1808-1846`)."""
    num_bands = 6
    pyr = scf_pyramid(img, height=2, nbands=num_bands)
    lp_bands = [b.real for b in pyr[1]] + [b.real for b in pyr[2]]
    subbands = norm_sender_normalized(lp_bands)

    feat = []
    for sb in subbands:
        feat.append(gamma_gen_gauss(sb.reshape(1, -1))[0])
    for i in range(num_bands):
        both = np.concatenate([subbands[i].ravel(),
                               subbands[i + num_bands].ravel()])
        feat.append(gamma_gen_gauss(both[None])[0])
    hp_band = pyr[0]
    for sb in lp_bands:
        feat.append(_ssim_cs(_imresize_to(sb, hp_band.shape), hp_band))
    for i in range(num_bands):
        for j in range(i + 1, num_bands):
            feat.append(_ssim_cs(subbands[i], subbands[j]))
    return np.asarray(feat)


# ---------------------------------------------------------------------------
# f3: SVD features
# ---------------------------------------------------------------------------


def _im2col_distinct(img: np.ndarray, kernel: int) -> np.ndarray:
    h, w = img.shape
    h2, w2 = math.ceil(h / kernel), math.ceil(w / kernel)
    x = np.pad(img, ((0, h2 * kernel - h), (0, w2 * kernel - w)))
    blocks = x.reshape(h2, kernel, w2, kernel).transpose(0, 2, 1, 3)
    # torch unfold flattens channel-major: (kh, kw) row-major per block,
    # blocks ordered row-major — and the resulting matrix is
    # (num_blocks, kernel*kernel)
    return blocks.reshape(h2 * w2, kernel * kernel)


def svd_features(img: np.ndarray, kernel: int = 5) -> np.ndarray:
    col = _im2col_distinct(img, kernel)
    return np.linalg.svd(col, compute_uv=False)


# ---------------------------------------------------------------------------
# full metric
# ---------------------------------------------------------------------------


def nrqm_features(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """img: (H, W) float64 in [0, 255]. Returns (f1 (18,), f2 (45,), f3 (75,))."""
    img = np.asarray(img, np.float64)
    pyr = gauss_pyramid(img / 255.0)
    f1 = np.concatenate([block_dct_features(im) for im in pyr])
    f2 = global_gsm_features(img)
    f3 = np.concatenate([svd_features(im) for im in pyr])
    return f1, f2, f3


def tree_regression(feat, ldau, rdau, threshold, pred, best_attr) -> float:
    """`:1847-1861` — MATLAB 1-based child/attribute indices."""
    prev_k = k = 0
    for _ in range(ldau.shape[0]):
        best_col = best_attr[k] - 1
        thresh = threshold[k]
        prev_k = k
        k = ldau[k] - 1 if feat[best_col] <= thresh else rdau[k] - 1
        if k == -1:
            break
    return float(pred[prev_k])


def random_forest_regression(feat, ldau, rdau, threshold, pred,
                             best_attr) -> float:
    tree_num = ldau.shape[1]
    preds = [tree_regression(feat, ldau[:, i], rdau[:, i], threshold[:, i],
                             pred[:, i], best_attr[:, i])
             for i in range(tree_num)]
    return float(np.mean(preds))


def nrqm_from_features(f1, f2, f3, linear_param, rf_params) -> float:
    preds = [1.0]
    for feat, rf in zip([f1, f2, f3], rf_params):
        preds.append(random_forest_regression(feat, *rf))
    return float(np.asarray(preds) @ np.asarray(linear_param).reshape(-1))


def load_nrqm_params(path: str):
    """Unpack the official NRQM_model.mat (`:1946-1960`)."""
    params = scipy.io.loadmat(path)["model"]
    linear = params["linear"][0, 0]
    rf_params = []
    for i in range(3):
        p = params["rf"][0, 0][0, i][0, 0]
        rf_params.append([np.asarray(p[0]), np.asarray(p[1]),
                          np.asarray(p[4]), np.asarray(p[5]),
                          np.asarray(p[6])])
    return linear, rf_params


def _to_y(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    if img.ndim == 3 and img.shape[2] == 3:
        # BGR (cv2 convention) -> YIQ luma == BT.601 luma, [0, 255]
        # (`metric/nrqm.py:1402-1422,1557-1570`, color_space='yiq')
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        img = 0.299 * r + 0.587 * g + 0.114 * b
    elif img.ndim == 3:
        img = img[..., 0]
    return img


def calculate_nrqm(img: np.ndarray, params_path: Optional[str] = None,
                   crop_border: int = 0) -> float:
    """img: (H, W) or (H, W, 1|3) uint8/float [0, 255] (BGR if colour).

    Requires the official 'NRQM_model.mat' regression parameters (the
    reference tree lacks them too — its loader points at a hard-coded
    cluster path, `metric/nrqm.py:1997`)."""
    if not params_path or not os.path.exists(params_path):
        raise FileNotFoundError(
            "NRQM requires the official 'NRQM_model.mat' parameters "
            "(not shipped; the reference repo lacks them too). "
            "Pass params_path= once obtained.")
    linear, rf_params = load_nrqm_params(params_path)
    img = _to_y(img)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    f1, f2, f3 = nrqm_features(img)
    return nrqm_from_features(f1, f2, f3, linear, rf_params)


def calculate_pi(img: np.ndarray, niqe_params_path: str,
                 nrqm_score: Optional[float] = None,
                 nrqm_params_path: Optional[str] = None,
                 crop_border: int = 4) -> float:
    """PI = 0.5 * ((10 - NRQM) + NIQE)  (`metric/nrqm.py:2010-2027`)."""
    from .niqe import calculate_niqe

    if nrqm_score is None:
        nrqm_score = calculate_nrqm(img, nrqm_params_path,
                                    crop_border=crop_border)
    niqe_score = calculate_niqe(img, niqe_params_path,
                                crop_border=crop_border)
    return 0.5 * ((10.0 - nrqm_score) + niqe_score)
