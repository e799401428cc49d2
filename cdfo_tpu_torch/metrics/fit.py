"""Pristine-model fitting for the no-reference metrics (a numpy copy of
``cdfo_tpu/metrics/fit.py``, whose package imports JAX; the tests hold the
two equal).

The reference consumes NIQE's ``niqe_modelparameters.mat`` and ILNIQE's
``templateModel`` .mat but ships no way to produce them (the ILNIQE
template is absent from its tree entirely — `metric/niqe.py:1503-1554`
loads a hard-coded path). These fitters implement the published training
procedures (Mittal et al. 2013 for NIQE; Zhang et al. 2015 for IL-NIQE)
on a user-supplied pristine image set, producing parameter files that
:func:`..niqe.calculate_niqe` / :func:`..ilniqe.calculate_ilniqe` load
directly — so both metrics are usable end-to-end without the official
binaries (scores then reflect the user's pristine corpus, not the
official one; for paper-comparable numbers use the official .mat files).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .ilniqe import ilniqe_features
from .niqe import compute_feature, mscn_and_sigma
from .matlab import imresize


def fit_niqe_params(images: Sequence[np.ndarray], block_size: int = 96,
                    sharpness_threshold: float = 0.75
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fit the NIQE pristine MVG (mu_prisparam, cov_prisparam).

    Published procedure: per image, compute the local-sigma field at
    scale 1, rank blocks by mean sigma ("sharpness") and keep blocks
    above ``sharpness_threshold * max``; compute the 18 MSCN features
    per kept block at both scales (MATLAB bicubic 0.5x between them);
    fit a multivariate Gaussian over all kept blocks of all images.

    images: grayscale (H, W) arrays in [0, 255] (H, W >= block_size).
    Returns (mu (36,), cov (36, 36)) — the arrays
    ``calculate_niqe(..., params_path)`` reads from the .mat.
    """
    all_feats = []
    for img in images:
        img = np.asarray(img, np.float64)
        h, w = img.shape
        nbh, nbw = h // block_size, w // block_size
        if nbh == 0 or nbw == 0:
            raise ValueError(f"image {img.shape} smaller than one "
                             f"{block_size}x{block_size} block")
        img = img[: nbh * block_size, : nbw * block_size]

        _, sigma = mscn_and_sigma(img)
        sharp = np.array([
            sigma[by * block_size:(by + 1) * block_size,
                  bx * block_size:(bx + 1) * block_size].mean()
            for by in range(nbh) for bx in range(nbw)])
        keep = sharp > sharpness_threshold * sharp.max()

        feats = []
        for scale in (1, 2):
            bs = block_size // scale
            norm = mscn_and_sigma(img)[0]
            feats.append(np.stack([
                compute_feature(
                    norm[by * bs:(by + 1) * bs, bx * bs:(bx + 1) * bs])
                for by in range(nbh) for bx in range(nbw)]))
            if scale == 1:
                img = imresize(img / 255.0, 0.5, antialiasing=True) * 255.0
        all_feats.append(np.concatenate(feats, axis=1)[keep])

    feats = np.concatenate(all_feats, axis=0)
    good = ~np.isnan(feats).any(axis=1)
    mu = np.nanmean(feats, axis=0)
    cov = np.cov(feats[good], rowvar=False)
    return mu, cov


def save_niqe_params(path: str, mu: np.ndarray, cov: np.ndarray) -> None:
    """Write a .mat `calculate_niqe` can load (mu_prisparam/cov_prisparam
    keys, the layout of the official ``niqe_modelparameters.mat``)."""
    import scipy.io

    scipy.io.savemat(path, {"mu_prisparam": np.asarray(mu, np.float64),
                            "cov_prisparam": np.asarray(cov, np.float64)})


def fit_ilniqe_template(images: Sequence[np.ndarray], resize: bool = True,
                        block_size: int = 84,
                        variance_keep: float = 0.9999,
                        n_components: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
    """Fit the IL-NIQE ``templateModel`` from pristine RGB images.

    Published procedure: extract the per-block quality-aware feature
    vectors from every pristine image (:func:`..ilniqe.ilniqe_features`
    — the identical front half of scoring), learn a PCA basis over them,
    and fit an MVG to the projected features. ``n_components`` overrides
    the ``variance_keep`` cumulative-explained-variance cut.

    images: (H, W, 3) RGB in [0, 255].
    Returns dict(mu_pris (k,), cov_pris (k, k), mean_of_sample (F,),
    principle_vectors (F, k)) — exactly the four ``templateModel`` slots
    ``calculate_ilniqe`` reads.
    """
    feats = np.concatenate([
        ilniqe_features(np.asarray(im, np.float64), resize=resize,
                        block_size=block_size)
        for im in images], axis=0)
    feats = feats[~np.isnan(feats).any(axis=1)]
    if feats.shape[0] < 2:
        raise ValueError("need >= 2 valid pristine blocks to fit a template")

    mean_of_sample = feats.mean(axis=0)
    xc = feats - mean_of_sample[None]
    # PCA via SVD of the centered matrix (F can exceed the block count;
    # eigh on the (F, F) covariance would be rank-deficient and slow)
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    var = s ** 2
    nz = int(np.sum(var > 1e-12 * var.max()))
    if n_components is None:
        csum = np.cumsum(var) / var.sum()
        n_components = int(np.searchsorted(csum, variance_keep) + 1)
    k = max(1, min(n_components, nz))
    pv = vt[:k].T                                    # (F, k)

    coeffs = xc @ pv                                 # (blocks, k)
    mu_pris = coeffs.mean(axis=0)
    cov_pris = np.cov(coeffs, rowvar=False).reshape(k, k)
    return {"mu_pris": mu_pris, "cov_pris": cov_pris,
            "mean_of_sample": mean_of_sample, "principle_vectors": pv}


def save_ilniqe_template(path: str, template: Dict[str, np.ndarray]) -> None:
    """Write a ``templateModel`` .mat `calculate_ilniqe` can load (the
    official file's cell-array layout: {mu, cov, mean_of_sample, PV})."""
    import scipy.io

    cell = np.empty((1, 4), object)
    cell[0, 0] = np.asarray(template["mu_pris"], np.float64)
    cell[0, 1] = np.asarray(template["cov_pris"], np.float64)
    cell[0, 2] = np.asarray(template["mean_of_sample"], np.float64)
    cell[0, 3] = np.asarray(template["principle_vectors"], np.float64)
    scipy.io.savemat(path, {"templateModel": cell})


# ---------------------------------------------------------------------------
# NRQM forest fitting (the metric's last external-binary gate)
# ---------------------------------------------------------------------------
#
# The official NRQM needs `NRQM_model.mat` — three random-forest
# regressors (one per feature group f1/f2/f3) plus a linear blend —
# which neither the reference tree nor this environment ships (its
# loader points at a hard-coded cluster path, `metric/nrqm.py:1997`).
# `fit_nrqm_forest` trains that model from a caller-supplied corpus of
# (image, MOS) pairs with a numpy CART random forest, and
# `save_nrqm_model` writes the official .mat layout that
# `..nrqm.load_nrqm_params` reads back — the same un-gating story as
# `fit_ilniqe_template` above. Ref: forest/blend evaluation plumbing
# `metric/nrqm.py:1847-1926,1970-2027`.


def _grow_cart(X: np.ndarray, y: np.ndarray, rng: np.random.RandomState,
               mtry: int, min_leaf: int = 5):
    """Grow one variance-reducing CART regression tree.

    Returns (ldau, rdau, threshold, pred, best_attr) int/float arrays in
    the `tree_regression` encoding: 1-based child indices, 0 = leaf,
    `feat[best_attr-1] <= threshold` goes left, prediction read at the
    leaf node."""
    ldau, rdau, thr, pred, attr = [], [], [], [], []

    def new_node(idx):
        ldau.append(0)
        rdau.append(0)
        thr.append(0.0)
        pred.append(float(y[idx].mean()))
        attr.append(1)
        return len(ldau) - 1

    def split(node, idx):
        if idx.size < 2 * min_leaf or np.ptp(y[idx]) == 0:
            return
        feats = rng.choice(X.shape[1], size=min(mtry, X.shape[1]),
                          replace=False)
        best = (0.0, None, None)          # (gain, feature, threshold)
        base = y[idx].var() * idx.size
        for f in feats:
            v = X[idx, f]
            order = np.argsort(v, kind="stable")
            vs, ys = v[order], y[idx][order]
            # candidate splits between distinct neighbour values
            csum = np.cumsum(ys)
            csq = np.cumsum(ys * ys)
            n = idx.size
            nl = np.arange(1, n)
            sl, ql = csum[:-1], csq[:-1]
            sr, qr = csum[-1] - sl, csq[-1] - ql
            ssel = (ql - sl * sl / nl) + (qr - sr * sr / (n - nl))
            valid = (vs[1:] != vs[:-1]) & (nl >= min_leaf) & \
                    (n - nl >= min_leaf)
            if not valid.any():
                continue
            ssel = np.where(valid, ssel, np.inf)
            j = int(np.argmin(ssel))
            gain = base - ssel[j]
            if gain > best[0]:
                best = (gain, int(f), 0.5 * (vs[j] + vs[j + 1]))
        if best[1] is None:
            return
        _, f, t = best
        left = idx[X[idx, f] <= t]
        right = idx[X[idx, f] > t]
        li = new_node(left)
        ri = new_node(right)
        ldau[node], rdau[node] = li + 1, ri + 1   # 1-based
        thr[node], attr[node] = float(t), f + 1   # 1-based
        split(li, left)
        split(ri, right)

    root = new_node(np.arange(len(y)))
    split(root, np.arange(len(y)))
    return (np.asarray(ldau, np.int64), np.asarray(rdau, np.int64),
            np.asarray(thr, np.float64), np.asarray(pred, np.float64),
            np.asarray(attr, np.int64))


def _fit_forest(X: np.ndarray, y: np.ndarray, n_trees: int,
                rng: np.random.RandomState, min_leaf: int = 5):
    """Bootstrap-aggregated CART forest; per-tree arrays padded to a
    common node count and stacked column-per-tree (the official matrix
    layout `random_forest_regression` consumes)."""
    mtry = max(1, X.shape[1] // 3)
    trees = []
    for _ in range(n_trees):
        boot = rng.randint(0, len(y), size=len(y))
        trees.append(_grow_cart(X[boot], y[boot], rng, mtry, min_leaf))
    nmax = max(t[0].shape[0] for t in trees)

    def stack(i, dtype, fill):
        m = np.full((nmax, n_trees), fill, dtype)
        for c, t in enumerate(trees):
            m[:t[i].shape[0], c] = t[i]
        return m

    return [stack(0, np.int64, 0), stack(1, np.int64, 0),
            stack(2, np.float64, 0.0), stack(3, np.float64, 0.0),
            stack(4, np.int64, 1)]


def fit_nrqm_forest(images: Sequence[np.ndarray], mos: Sequence[float],
                    n_trees: int = 20, min_leaf: int = 5,
                    seed: int = 0) -> Dict[str, object]:
    """Train the NRQM regression model on (image, MOS) pairs.

    images: grayscale (H, W) arrays in [0, 255] (min side >= ~48 for the
    2-scale steerable pyramid + guardbands); mos: perceptual scores.
    Returns {"linear": (4, 1), "rf": [rf1, rf2, rf3]} where each rf is
    the [ldau, rdau, threshold, pred, best_attr] list
    `..nrqm.nrqm_from_features` consumes.
    """
    from .nrqm import nrqm_features, random_forest_regression

    rng = np.random.RandomState(seed)
    y = np.asarray(mos, np.float64)
    feats = [nrqm_features(np.asarray(im, np.float64)) for im in images]
    groups = [np.stack([f[i] for f in feats]) for i in range(3)]
    rfs = [_fit_forest(g, y, n_trees, rng, min_leaf) for g in groups]
    # linear blend on the forests' in-sample predictions (official model
    # blends [1, p1, p2, p3] -> score, `metric/nrqm.py:1970-2027`)
    P = np.stack([np.ones_like(y)] + [
        np.asarray([random_forest_regression(g[j], *rf)
                    for j in range(len(y))])
        for g, rf in zip(groups, rfs)], axis=1)
    linear, *_ = np.linalg.lstsq(P, y, rcond=None)
    return {"linear": linear.reshape(-1, 1), "rf": rfs}


def save_nrqm_model(path: str, model: Dict[str, object]) -> None:
    """Write an ``NRQM_model.mat`` that `..nrqm.load_nrqm_params` loads.

    Field POSITIONS match the official randomForest struct the loader
    indexes positionally (0=ldau, 1=rdau, 4=threshold, 5=pred,
    6=best_attr; 2/3 are bookkeeping the evaluator never reads).
    """
    import scipy.io

    fields = ["ldau", "rdau", "nodestatus", "ndbigtree", "upper",
              "avnode", "mbest"]
    rf_cell = np.empty((1, 3), object)
    for i, rf in enumerate(model["rf"]):
        ldau, rdau, thr, pred, attr = rf
        nnode = np.asarray(ldau).shape[0]
        vals = [ldau, rdau, np.zeros_like(ldau),
                np.full((1, np.asarray(ldau).shape[1]), nnode), thr, pred,
                attr]
        s = np.empty((1, 1), dtype=[(f, object) for f in fields])
        for f, v in zip(fields, vals):
            s[0, 0][f] = np.asarray(v)
        rf_cell[0, i] = s
    model_s = np.empty((1, 1), dtype=[("linear", object), ("rf", object)])
    model_s[0, 0]["linear"] = np.asarray(model["linear"], np.float64)
    model_s[0, 0]["rf"] = rf_cell
    scipy.io.savemat(path, {"model": model_s})
