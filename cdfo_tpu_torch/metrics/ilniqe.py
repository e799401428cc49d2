"""IL-NIQE, the Integrated Local NIQE (numpy, float64; a copy of
``cdfo_tpu/metrics/ilniqe.py``, whose package imports JAX; the tests hold
the two equal).

The reference ships an ILNIQE path (`metric/niqe.py:
1256-1459`) that is BROKEN as shipped: `_construct_filters` calls
`get_meshgrid` / `ifftshift` / `_lowpassfilter` which are defined nowhere in
the module (NameError on first use). This is a repaired, runnable
implementation following the same pipeline (O-colour-space struct/gradient/
log-opponent features + log-Gabor responses, 84x84 blocks at two scales,
PCA projection, per-block MVG distance) against the official
``niqe_image_params.mat`` template model the reference ships.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .matlab import fspecial_gaussian, imfilter, imresize
from .niqe import estimate_aggd_param, normalize_img_with_gauss

EPS = 1e-8

_O_WEIGHT = np.array([[0.3, 0.04, -0.35],
                      [0.34, -0.6, 0.17],
                      [0.06, 0.63, 0.27]], np.float64)


def fitweibull(x: np.ndarray, iters: int = 50, eps: float = 1e-2) -> Tuple[float, float]:
    """MLE Weibull fit, Newton-Raphson on the shape (`metric/niqe.py:233-273`).
    x: 1-D positive samples. Returns (shape, scale)."""
    x = x[x > 0]
    if x.size == 0:
        return float("nan"), float("nan")
    ln_x = np.log(x)
    k = 1.2 / (np.std(ln_x, ddof=1) + 1e-12)
    k_prev = k
    for _ in range(iters):
        x_k = x ** k
        x_k_ln_x = x_k * ln_x
        ff = np.sum(x_k_ln_x)
        fg = np.sum(x_k)
        f = ff / fg - np.mean(ln_x) - 1.0 / k
        ff_prime = np.sum(x_k_ln_x * ln_x)
        f_prime = (ff_prime / fg - (ff / fg) ** 2) + 1.0 / (k * k)
        k = k - f / f_prime
        if not np.isfinite(k):
            return float("nan"), float("nan")
        if abs(k - k_prev) < eps:
            break
        k_prev = k
    lam = np.mean(x ** k) ** (1.0 / k)
    return float(k), float(lam)


def _gau_derivative(sigma: float) -> Tuple[np.ndarray, np.ndarray]:
    half = math.ceil(3 * sigma)
    xs = np.linspace(-half, half, 2 * half + 1)
    x, y = np.meshgrid(xs, xs)
    g = np.exp(-(x ** 2 + y ** 2) / (2 * sigma * sigma))
    return x * g, y * g


def _get_meshgrid(size) -> Tuple[np.ndarray, np.ndarray]:
    def axis(n):
        if n % 2:
            return np.arange(-(n - 1) / 2, n / 2) / (n - 1)
        return np.arange(-n / 2, n / 2) / n

    return np.meshgrid(axis(size[0]), axis(size[1]), indexing="ij")


def _construct_log_gabor(size, scales=3, orientations=4, min_length=2.4,
                         sigma_f=0.55, mult=1.31, delta_theta=1.10):
    h, w = size
    theta_sigma = math.pi / (orientations * delta_theta)
    gx, gy = _get_meshgrid((h, w))
    radius = np.fft.ifftshift(np.sqrt(gx ** 2 + gy ** 2))
    theta = np.fft.ifftshift(np.arctan2(-gy, gx))
    radius[0, 0] = 1.0
    sin_t, cos_t = np.sin(theta), np.cos(theta)

    gabors = []
    for s in range(scales):
        omega0 = 1.0 / (min_length * mult ** s)
        g = np.exp(-(np.log(radius / omega0) ** 2) / (2 * math.log(sigma_f) ** 2))
        g[0, 0] = 0.0
        gabors.append(g)
    spreads = []
    for o in range(orientations):
        angl = o * math.pi / orientations
        ds = sin_t * math.cos(angl) - cos_t * math.sin(angl)
        dc = cos_t * math.cos(angl) + sin_t * math.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        spreads.append(np.exp(-(dtheta ** 2) / (2 * theta_sigma ** 2)))
    # scale-major within orientation, then transposed like the reference's
    # matlab-compat fixup (`:1350-1352`)
    filters = [ (spreads[o] * gabors[s]).T
                for s in range(scales) for o in range(orientations) ]
    return filters


def _conv_flip_same(img, kernel):
    """matlab conv2 'same' with zero padding (`metric/niqe.py:760-773`)."""
    return imfilter(img, kernel[::-1, ::-1], "constant")


def _block_features(block_stack: np.ndarray) -> np.ndarray:
    """ILNIQE per-block features (`metric/niqe.py:1070-1142`):
    block_stack: (C=109, bh, bw)."""
    feat = []
    b0 = block_stack[0]
    alpha, bl, br = estimate_aggd_param(b0)
    feat += [alpha, (bl + br) / 2]
    from scipy.special import gamma as _g
    for sh in [(0, 1), (1, 0), (1, 1), (1, -1)]:
        shifted = np.roll(b0, sh, axis=(0, 1))
        alpha, bl, br = estimate_aggd_param(b0 * shifted)
        mean = (br - bl) * (_g(2 / alpha) / _g(1 / alpha))
        feat += [alpha, mean, bl, br]
    for c in range(1, 4):       # weibull on gradient magnitudes (scale,shape)
        shape, scale = fitweibull(block_stack[c].ravel())
        feat += [scale, shape]
    for c in range(4, 7):       # mu/var of log-opponent channels
        feat += [float(np.mean(block_stack[c])),
                 float(np.var(block_stack[c]))]
    for c in range(7, 85):      # AGGD on log-gabor responses/derivatives
        alpha, bl, br = estimate_aggd_param(block_stack[c])
        feat += [alpha, (bl + br) / 2]
    for c in range(85, 109):    # weibull on response GMs
        shape, scale = fitweibull(block_stack[c].ravel())
        feat += [scale, shape]
    return np.asarray(feat, np.float64)


def ilniqe_features(img: np.ndarray, resize: bool = True,
                    block_size: int = 84) -> np.ndarray:
    """Per-block ILNIQE feature matrix (n_blocks, F) over both scales —
    the shared front half of scoring (:func:`ilniqe`) and template
    fitting (`fit.py::fit_ilniqe_template`). img: (H, W, 3) RGB float64
    in [0, 255]."""
    sigma_gau_der = 1.66
    k_for_log = 1e-5
    normalized_width = 524
    sf_log = 0.87
    sf_gau = 0.28
    sigma_ds = 0.9
    inf_const = 10000

    if resize:
        chans = [imresize(img[..., c] / 255.0,
                          normalized_width / img.shape[0])
                 for c in range(3)]
        img = np.stack([np.clip(c * 255.0, 0, 255) for c in chans], -1)
        img = img[:normalized_width, :normalized_width]

    h, w = img.shape[:2]
    nbh, nbw = h // block_size, w // block_size
    img = img[: nbh * block_size, : nbw * block_size]
    o_img = img @ _O_WEIGHT.T

    feats_scales = []
    for scale in (1, 2):
        bs = block_size // scale
        struct_dis = normalize_img_with_gauss5(o_img[..., 2])
        dx, dy = _gau_derivative(sigma_gau_der / (scale ** sf_gau))
        ix = np.stack([_conv_flip_same(o_img[..., c], dx) for c in range(3)], 0)
        iy = np.stack([_conv_flip_same(o_img[..., c], dy) for c in range(3)], 0)
        gm = np.sqrt(ix ** 2 + iy ** 2 + EPS)
        ixy = np.empty((6, *ix.shape[1:]))
        ixy[0::2] = ix
        ixy[1::2] = iy

        log_rgb = np.log(img + k_for_log)
        log_ms = log_rgb - log_rgb.mean(axis=(0, 1), keepdims=True)
        intensity = log_ms.sum(-1) / np.sqrt(3)
        by = (log_ms[..., 0] + log_ms[..., 1] - 2 * log_ms[..., 2]) / np.sqrt(6)
        rg = (log_ms[..., 0] - log_ms[..., 1]) / np.sqrt(2)

        composite = [struct_dis] + list(gm) + [intensity, by, rg] + list(ixy)

        o3 = o_img[..., 2]
        filters = _construct_log_gabor(
            o3.shape, min_length=2.4 / (scale ** sf_log))
        fft_im = np.fft.fft2(o3)
        log_resp, partial_der, resp_gm = [], [], []
        for f in filters:
            resp = np.fft.ifft2(f * fft_im)
            rr, ri = np.real(resp), np.imag(resp)
            pxr = _conv_flip_same(rr, dx)
            pyr = _conv_flip_same(rr, dy)
            pxi = _conv_flip_same(ri, dx)
            pyi = _conv_flip_same(ri, dy)
            log_resp += [rr, ri]
            partial_der += [pxr, pyr, pxi, pyi]
            resp_gm += [np.sqrt(pxr ** 2 + pyr ** 2 + EPS),
                        np.sqrt(pxi ** 2 + pyi ** 2 + EPS)]
        composite = np.stack(composite + log_resp + partial_der + resp_gm, 0)

        blocks = []
        for iy_ in range(nbh):
            for ix_ in range(nbw):
                blocks.append(_block_features(
                    composite[:, iy_ * bs:(iy_ + 1) * bs,
                              ix_ * bs:(ix_ + 1) * bs]))
        feats_scales.append(np.stack(blocks))

        if scale == 1:
            gau = fspecial_gaussian(math.ceil(6 * sigma_ds), sigma_ds)
            o_img = np.stack([imfilter(o_img[..., c], gau, "edge")[::2, ::2]
                              for c in range(3)], -1)
            img = np.stack([imfilter(img[..., c], gau, "edge")[::2, ::2]
                            for c in range(3)], -1)

    feats = np.concatenate(feats_scales, axis=1)
    return np.clip(feats, -np.inf, inf_const)


def ilniqe(img: np.ndarray, mu_pris, cov_pris, principle_vectors,
           mean_of_sample, resize: bool = True, block_size: int = 84) -> float:
    """img: (H, W, 3) RGB float64 in [0, 255]."""
    feats = ilniqe_features(img, resize=resize, block_size=block_size)

    coeffs = principle_vectors.T @ (feats - mean_of_sample[None]).T
    final = coeffs.T                                  # (blocks, feat)
    good = ~np.isnan(final).any(axis=1)
    cov_dist = np.cov(final[good], rowvar=False)
    mu_final = np.nanmean(final, axis=0)
    final = np.where(np.isnan(final), mu_final[None], final)
    invcov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    diff = final - mu_pris[None]
    q = np.sqrt(np.maximum(np.sum((diff @ invcov) * diff, axis=-1), 0))
    return float(np.mean(q))


def normalize_img_with_gauss5(img: np.ndarray) -> np.ndarray:
    kernel = fspecial_gaussian(5, 5.0 / 6.0)
    mu = imfilter(img, kernel, "edge")
    sigma = np.sqrt(np.abs(imfilter(img * img, kernel, "edge") - mu * mu))
    return (img - mu) / (sigma + 1.0)


def calculate_ilniqe(img: np.ndarray, params_path: str,
                     crop_border: int = 0, resize: bool = True) -> float:
    """img: (H, W, 3) RGB uint8/float [0, 255]. ``resize`` selects the
    official normalise-to-524 protocol; scoring must use the SAME setting
    the template was fitted with (`fit.py::fit_ilniqe_template`) or the
    pristine statistics don't line up."""
    import scipy.io

    params = scipy.io.loadmat(params_path)
    if "templateModel" not in params:
        raise KeyError(
            "ILNIQE needs the official 'templateModel' .mat "
            f"(got keys {[k for k in params if not k.startswith('__')]} — "
            "that is a NIQE parameter file). The reference repo ships no "
            "ILNIQE template either (its ILNIQE is unrunnable as shipped); "
            "obtain ILNIQE_templateModel.mat from the official release.")
    tm = params["templateModel"]
    mu_pris = np.ravel(tm[0][0]).astype(np.float64)
    cov_pris = tm[0][1].astype(np.float64)
    mean_of_sample = np.ravel(tm[0][2]).astype(np.float64)
    principle_vectors = tm[0][3].astype(np.float64)

    img = np.round(np.asarray(img, np.float64))
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return ilniqe(img, mu_pris, cov_pris, principle_vectors, mean_of_sample,
                  resize=resize)
