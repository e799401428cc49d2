"""The port's training data pipeline against cdfo_tpu's, on the CPU: the
standard-library PNG codec against ``cv2`` and PIL on files each wrote; the
synthetic CVCP tree, the ``CVCPDataset`` arrays (in RAM and through the
memmap cache) and the ``TrainBatcher`` batches (LD and RA, same seeds)
equal to cdfo_tpu's; and the io module with neither library (as on a
machine without them) reading the same tree.
"""
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from cdfo_tpu.config import DataConfig as JDataConfig
from cdfo_tpu.data.dataset import CVCPDataset as JDataset
from cdfo_tpu.data.dataset import TrainBatcher as JBatcher
from cdfo_tpu.data.io import make_synthetic_cvcp_tree as j_tree
from cdfo_tpu_torch.config import DataConfig
from cdfo_tpu_torch.data import io as tio
from cdfo_tpu_torch.data import png
from cdfo_tpu_torch.data.dataset import CVCPDataset, TrainBatcher

ARRAYS = ("lr", "hr", "pm", "rm", "uf", "mv0", "mv1", "qp")


def _images(seed):
    r = np.random.RandomState(seed)
    gray = r.randint(0, 256, (23, 37), dtype=np.uint8)
    gray[5:15, 3:30] = np.arange(27, dtype=np.uint8)[None] * 9  # smooth runs
    rgb = r.randint(0, 256, (19, 26, 3), dtype=np.uint8)
    rgb[:, :10] = rgb[:1, :10]                                   # repeated rows
    return gray, rgb


@pytest.mark.parametrize("writer", ["cv2", "pil", "stdlib"])
def test_png_codec_against_cv2_and_pil(tmp_path, writer):
    """Gray and RGB files written by each of the three read back equal by
    all three (cv2's and PIL's adaptive filters take Sub, Up and Paeth
    rows); an RGB file read as gray equals cv2's luma within 1."""
    gray, rgb = _images(0)
    pg, pc = str(tmp_path / "g.png"), str(tmp_path / "c.png")
    if writer == "cv2":
        cv2.imwrite(pg, gray)
        cv2.imwrite(pc, rgb[..., ::-1])
    elif writer == "pil":
        Image.fromarray(gray).save(pg)
        Image.fromarray(rgb).save(pc)
    else:
        png.write_png(pg, gray)
        png.write_png(pc, rgb)
    for path, img in ((pg, gray), (pc, rgb)):
        np.testing.assert_array_equal(png.read_png(path), img)
        np.testing.assert_array_equal(np.array(Image.open(path)), img)
        flag = cv2.IMREAD_UNCHANGED
        got = cv2.imread(path, flag)
        np.testing.assert_array_equal(got if img.ndim == 2 else
                                      got[..., ::-1], img)
    luma = png.rgb_to_gray(png.read_png(pc)).astype(np.int16)
    assert np.abs(luma - cv2.imread(pc, 0)).max() <= 1


def _filtered_png(img, kinds):
    """PNG bytes of uint8 ``img`` with row y filtered by kinds[y % 5]
    (the forward filters of the PNG specification)."""
    h = img.shape[0]
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        kind, cur = kinds[y % len(kinds)], rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][kind]
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    header = png.struct.pack(">IIBBBBB", img.shape[1], h, 8,
                             0 if bpp == 1 else 2, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", png.zlib.compress(b"".join(out)))
            + png._chunk(b"IEND", b""))


def test_png_codec_reads_every_filter_type(tmp_path):
    """Rows filtered None, Sub, Up, Average and Paeth in turn: the codec
    reads them as PIL and cv2 do."""
    for img in _images(1):
        path = str(tmp_path / f"f{img.ndim}.png")
        with open(path, "wb") as f:
            f.write(_filtered_png(img, [0, 1, 2, 3, 4]))
        np.testing.assert_array_equal(np.array(Image.open(path)), img)
        np.testing.assert_array_equal(png.read_png(path), img)
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got if img.ndim == 2 else
                                      got[..., ::-1], img)


def test_png_codec_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "a.png")
    Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(path)   # RGBA
    with pytest.raises(ValueError, match="colour type 6"):
        png.read_png(path)
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(path)     # 16-bit
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4), np.float32))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same synthetic tree written by each package, per coding config."""
    out = {}
    for cfg in ("LD", "RA"):
        roots = []
        for make in (j_tree, tio.make_synthetic_cvcp_tree):
            root = str(tmp_path_factory.mktemp(f"{cfg}_{make.__module__[:8]}"))
            names = make(root, num_seqs=2, frames=9, h=16, w=24, cfg=cfg,
                         seed=3)
            roots.append((root, names))
        out[cfg] = roots
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_trees(jroot, troot, min_files):
    files = _files(jroot)
    assert files == _files(troot) and len(files) > min_files
    for f in files:
        a, b = os.path.join(jroot, f), os.path.join(troot, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(tio.read_gray(a), tio.read_gray(b))
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert open(a).read() == open(b).read()


def test_synthetic_tree_equals_cdfo_tpus(trees, tmp_path):
    """The noise tree, and the structured one (MATLAB-bicubic LR of
    textured HR, through the port's copy of ``imresize``)."""
    (jroot, jnames), (troot, tnames) = trees["LD"]
    assert jnames == tnames
    assert_same_trees(jroot, troot, 100)
    kw = dict(num_seqs=1, frames=3, h=16, w=24, seed=5, structured=True)
    jnames = j_tree(str(tmp_path / "j"), **kw)
    assert jnames == tio.make_synthetic_cvcp_tree(str(tmp_path / "t"), **kw)
    assert_same_trees(str(tmp_path / "j"), str(tmp_path / "t"), 20)


def _configs(cfg):
    kw = dict(coding_cfg=cfg, frames_per_seq=9, crop_size=8,
              zero_mvl1_in_train=cfg == "LD")
    return JDataConfig(**kw), DataConfig(**kw)


@pytest.mark.parametrize("cfg", ["LD", "RA"])
def test_dataset_and_batches_equal_cdfo_tpus(trees, tmp_path, cfg):
    """Arrays in RAM and through the memmap cache, then three batches of
    the same seed (crops, flips and rotations, the LD or RA MV expansion,
    LD's zeroed L1 flows)."""
    jcfg, tcfg = _configs(cfg)
    (jroot, _), _ = trees[cfg]
    jds = JDataset(jroot, jcfg)
    tds = CVCPDataset(jroot, tcfg)
    cached = CVCPDataset(jroot, tcfg, cache_path=str(tmp_path / "cache"))
    again = CVCPDataset(jroot, tcfg, cache_path=str(tmp_path / "cache"))
    for name in ARRAYS:
        ref = getattr(jds, name)
        for ds in (tds, cached, again):
            np.testing.assert_array_equal(getattr(ds, name), ref)
    assert isinstance(again.lr, np.memmap)
    jb, tb = JBatcher(jds, 3, 8, seed=5), TrainBatcher(tds, 3, 8, seed=5)
    for _ in range(3):
        a, b = jb.sample_batch(), tb.sample_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    if cfg == "LD":
        assert not b["mvs1"].any() and b["mvs0"].any()
    prefetched = next(TrainBatcher(tds, 3, 8, seed=5).prefetch())
    first = JBatcher(jds, 3, 8, seed=5).sample_batch()
    for k in first:
        np.testing.assert_array_equal(prefetched[k], first[k])


def test_io_without_cv2_or_pil_reads_the_same_tree(trees, monkeypatch):
    """With neither library the io module writes and reads through the
    standard-library codec: a tree it writes equals cdfo_tpu's, array for
    array, and it reads cdfo_tpu's (cv2-written) tree alike."""
    (jroot, _), _ = trees["LD"]
    monkeypatch.setattr(tio, "cv2", None)
    monkeypatch.setattr(tio, "Image", None)
    jcfg, tcfg = _configs("LD")
    ref = JDataset(jroot, jcfg)
    np.testing.assert_array_equal(CVCPDataset(jroot, tcfg).hr, ref.hr)
    root = jroot + "_stdlib"
    tio.make_synthetic_cvcp_tree(root, num_seqs=2, frames=9, h=16, w=24,
                                 cfg="LD", seed=3)
    stdlib = CVCPDataset(root, tcfg)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(stdlib, name),
                                      getattr(ref, name))
