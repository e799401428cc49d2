"""The port's no-reference metrics and their fits
(``cdfo_tpu_torch/metrics/{niqe,brisque,ilniqe,nrqm,fit,video_quality}.py``)
against ``cdfo_tpu``'s on the same inputs, float64, within 1e-12 relative
(the copies are function for function; bit-equal where nothing differs):

- NIQE on params ``fit_niqe_params`` fits here from seeded smooth images,
  saved and loaded through the .mat layout;
- IL-NIQE on a template ``fit_ilniqe_template`` fits here (no resize);
- BRISQUE on an ``(sv_coef, sv)`` .pth built here;
- NRQM and PI on a forest ``fit_nrqm_forest`` fits here;
- the fits themselves, and ``cal_sequence_noref`` on a small PNG tree.
"""
import os

import numpy as np
import pytest
import scipy.io
import torch
from scipy.ndimage import gaussian_filter

from cdfo_tpu.metrics import brisque as jb
from cdfo_tpu.metrics import fit as jf
from cdfo_tpu.metrics import ilniqe as ji
from cdfo_tpu.metrics import niqe as jn
from cdfo_tpu.metrics import nrqm as jq
from cdfo_tpu.metrics import video_quality as jvq
from cdfo_tpu_torch.data.io import write_gray
from cdfo_tpu_torch.metrics import brisque as tb
from cdfo_tpu_torch.metrics import fit as tf
from cdfo_tpu_torch.metrics import ilniqe as ti
from cdfo_tpu_torch.metrics import niqe as tn
from cdfo_tpu_torch.metrics import nrqm as tq
from cdfo_tpu_torch.metrics import video_quality as tvq


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def smooth(r, h, w, c=None):
    """Smoothed noise with a little texture, in [0, 255]."""
    shape = (h, w) if c is None else (h, w, c)
    img = gaussian_filter(r.rand(*shape), (2.0, 2.0) + (() if c is None
                                                       else (0,)))
    img = img + 0.1 * (r.rand(*shape) - 0.5)
    img = img - img.min()
    return img / img.max() * 255.0


@pytest.fixture(scope="module")
def niqe_params(tmp_path_factory):
    r = np.random.RandomState(0)
    pristine = [smooth(r, 192, 192) for _ in range(4)]
    mu, cov = tf.fit_niqe_params(pristine)
    jmu, jcov = jf.fit_niqe_params(pristine)
    close(mu, jmu)
    close(cov, jcov)
    path = str(tmp_path_factory.mktemp("niqe") / "niqe.mat")
    tf.save_niqe_params(path, mu, cov)
    saved = scipy.io.loadmat(path)
    jpath = path[:-4] + "_jax.mat"
    jf.save_niqe_params(jpath, jmu, jcov)
    for k in ("mu_prisparam", "cov_prisparam"):
        np.testing.assert_array_equal(saved[k], scipy.io.loadmat(jpath)[k])
    return path


def test_niqe_matches(niqe_params):
    r = np.random.RandomState(1)
    img = smooth(r, 200, 200)
    noisy = np.clip(img + r.randn(200, 200) * 40, 0, 255).astype(np.uint8)
    for im in (img.astype(np.uint8), noisy):
        close(tn.calculate_niqe(im, niqe_params),
              jn.calculate_niqe(im, niqe_params))
    block = tn.normalize_img_with_gauss(img)[:48, :48]
    close(tn.compute_feature(block), jn.compute_feature(block))
    close(tn.estimate_aggd_param(block), jn.estimate_aggd_param(block))
    for a, b in zip(tn.mscn_and_sigma(img), jn.mscn_and_sigma(img)):
        close(a, b)
    colour = np.stack([img, noisy, img[::-1]], -1)
    close(tn.calculate_niqe(colour, niqe_params, crop_border=4),
          jn.calculate_niqe(colour, niqe_params, crop_border=4))


def test_ilniqe_fit_and_score_match(tmp_path):
    r = np.random.RandomState(2)
    pristine = [smooth(r, 168, 168, 3) for _ in range(2)]
    tpl = tf.fit_ilniqe_template(pristine, resize=False)
    jtpl = jf.fit_ilniqe_template(pristine, resize=False)
    assert tpl.keys() == jtpl.keys()
    for k in tpl:
        close(np.abs(tpl[k]), np.abs(jtpl[k]))   # an SVD's signs aside
    path = str(tmp_path / "ilniqe.mat")
    tf.save_ilniqe_template(path, jtpl)
    img = np.clip(smooth(r, 168, 168, 3) + r.randn(168, 168, 3) * 20, 0, 255)
    close(ti.calculate_ilniqe(img, path, resize=False),
          ji.calculate_ilniqe(img, path, resize=False))


def test_brisque_matches(tmp_path):
    r = np.random.RandomState(3)
    path = str(tmp_path / "brisque_svm_weights.pth")
    torch.save((torch.from_numpy(r.randn(20)),
                torch.from_numpy(r.rand(36, 20))), path)
    for img in (smooth(r, 96, 128), smooth(r, 64, 64, 3)):
        close(tb.calculate_brisque(img, path), jb.calculate_brisque(img, path))
    close(tb.natural_scene_statistics(img[..., 0]),
          jb.natural_scene_statistics(img[..., 0]))


def corpus(n, seed, h=64, w=64):
    """Images at graded blur levels; MOS = sharpness grade."""
    r = np.random.RandomState(seed)
    imgs, mos = [], []
    for i in range(n):
        base = gaussian_filter(r.rand(h, w) * 255.0, 1.0)
        base += 40.0 * np.sin(np.arange(w) / 3.0)[None, :]
        sigma = (i % 4) * 0.8
        imgs.append(np.clip(gaussian_filter(base, sigma) if sigma else base,
                            0, 255))
        mos.append(8.0 - 2.0 * (i % 4))
    return imgs, np.asarray(mos)


@pytest.fixture(scope="module")
def nrqm_model(tmp_path_factory):
    imgs, mos = corpus(8, seed=0)
    model = tf.fit_nrqm_forest(imgs, mos, n_trees=3, seed=0)
    jmodel = jf.fit_nrqm_forest(imgs, mos, n_trees=3, seed=0)
    close(model["linear"], jmodel["linear"])
    for rf, jrf in zip(model["rf"], jmodel["rf"]):
        for a, b in zip(rf, jrf):
            close(a, b)
    path = str(tmp_path_factory.mktemp("nrqm") / "NRQM_model.mat")
    tf.save_nrqm_model(path, model)
    for a, b in zip(tq.load_nrqm_params(path)[1],
                    jq.load_nrqm_params(path)[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    return path


def test_nrqm_and_pi_match(nrqm_model, niqe_params):
    r = np.random.RandomState(4)
    img = np.clip(smooth(r, 104, 104) + r.randn(104, 104) * 5, 0, 255)
    close(tq.calculate_nrqm(img, nrqm_model),
          jq.calculate_nrqm(img, nrqm_model))
    for a, b in zip(tq.nrqm_features(img), jq.nrqm_features(img)):
        close(a, b)
    close(tq.calculate_pi(img, niqe_params, nrqm_params_path=nrqm_model),
          jq.calculate_pi(img, niqe_params, nrqm_params_path=nrqm_model))
    with pytest.raises(FileNotFoundError):
        tq.calculate_nrqm(img, None)


def test_cal_sequence_noref_matches(tmp_path, niqe_params, nrqm_model,
                                    monkeypatch):
    r = np.random.RandomState(5)
    for i in range(2):
        write_gray(str(tmp_path / "seq" / f"{i:05d}.png"),
                   smooth(r, 104, 104).astype(np.uint8))
    brisque = str(tmp_path / "brisque.pth")
    torch.save((torch.from_numpy(r.randn(10)),
                torch.from_numpy(r.rand(36, 10))), brisque)
    monkeypatch.delenv("CDFO_NRQM_MODEL", raising=False)
    assert tvq.default_nrqm_model() is None
    assert os.path.dirname(tvq.__file__).endswith(
        os.path.join("cdfo_tpu_torch", "metrics"))
    plain = tvq.cal_sequence_noref(str(tmp_path / "seq"), niqe_params)
    assert plain.keys() == {"niqe", "frames"} and plain["frames"] == 2
    monkeypatch.setenv("CDFO_NRQM_MODEL", nrqm_model)
    assert tvq.default_nrqm_model() == nrqm_model
    got = tvq.cal_sequence_noref(str(tmp_path / "seq"), niqe_params,
                                 brisque_weights=brisque)
    want = jvq.cal_sequence_noref(str(tmp_path / "seq"), niqe_params,
                                  brisque_weights=brisque)
    assert got.keys() == want.keys() == {"niqe", "brisque", "nrqm", "pi",
                                         "frames"}
    for k in want:
        close(got[k], want[k])
