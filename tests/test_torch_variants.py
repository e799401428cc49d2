"""The port's dataset variants (``cdfo_tpu_torch/data/variants.py``)
against ``cdfo_tpu/data/variants.py`` on the same trees and seeds, bit for
bit: ``FramePairDataset`` (flat and vimeo layouts), ``LRBatcher`` (7
frames, and the 13-frame window with ``all_gt``), ``single_mv_batch`` and
``make_synthetic_frame_tree``."""
import os

import numpy as np
import pytest

from cdfo_tpu.data import variants as jv
from cdfo_tpu_torch.data import variants as tv


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def flat_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    names = tv.make_synthetic_frame_tree(root, num_seqs=2, frames=14, h=24,
                                         w=32, seed=3)
    return root, names


def test_synthetic_frame_tree_matches(tmp_path, flat_tree):
    root, names = flat_tree
    want = jv.make_synthetic_frame_tree(str(tmp_path), num_seqs=2, frames=14,
                                        h=24, w=32, seed=3)
    assert names == want
    for seq in names:
        for sub in ("lr", "hr"):
            a = sorted(os.listdir(os.path.join(root, sub, seq)))
            assert a == sorted(os.listdir(os.path.join(tmp_path, sub, seq)))
            for f in a:
                assert (open(os.path.join(root, sub, seq, f), "rb").read()
                        == open(os.path.join(tmp_path, sub, seq, f),
                                "rb").read())


@pytest.mark.parametrize("nframes,all_gt,augment", [
    (7, False, True), (7, False, False), (13, True, True), (13, False, True)])
def test_lr_batcher_matches(flat_tree, nframes, all_gt, augment):
    root, names = flat_tree
    lr, hr = os.path.join(root, "lr"), os.path.join(root, "hr")
    jds = jv.FramePairDataset(lr, hr, names, frames_per_seq=14)
    tds = tv.FramePairDataset(lr, hr, names, frames_per_seq=14)
    np.testing.assert_array_equal(tds.lr, jds.lr)
    np.testing.assert_array_equal(tds.hr, jds.hr)
    assert len(tds) == len(jds) == 2
    kw = dict(batch_size=3, crop=16, nframes=nframes, seed=7,
              augment=augment, all_gt=all_gt)
    jb, tb = jv.LRBatcher(jds, **kw), tv.LRBatcher(tds, **kw)
    for _ in range(2):
        want, got = jb.sample_batch(), tb.sample_batch()
        assert_batches_equal(got, want)
    assert got["lrs"].shape == (3, nframes, 16, 16, 1)
    assert got["hr"].shape == ((3, nframes, 64, 64, 1) if all_gt
                               else (3, 64, 64, 1))
    assert_batches_equal(tv.single_mv_batch(got), jv.single_mv_batch(want))
    assert next(iter(tb)).keys() == want.keys()


def test_vimeo_layout_matches(tmp_path):
    """Vimeo90K's ``<clip>/<subclip>/im%d.png`` grammar: a clip expands to
    its subclips, a ``clip/subclip`` entry stays as it is."""
    r = np.random.RandomState(0)
    for sub in ("lr", "hr"):
        for clip, subclips in (("00001", ("0001", "0002")), ("00002", ("0001",))):
            for s in subclips:
                for i in range(1, 8):
                    size = (8, 12) if sub == "lr" else (32, 48)
                    tv.write_gray(str(tmp_path / sub / clip / s / f"im{i}.png"),
                                  r.randint(0, 255, size, dtype=np.uint8))
    args = (str(tmp_path / "lr"), str(tmp_path / "hr"), ["00001", "00002/0001"],
            7)
    jds = jv.FramePairDataset(*args, layout="vimeo")
    tds = tv.FramePairDataset(*args, layout="vimeo")
    assert tds.seqs == jds.seqs == ["00001/0001", "00001/0002", "00002/0001"]
    np.testing.assert_array_equal(tds.lr, jds.lr)
    np.testing.assert_array_equal(tds.hr, jds.hr)
    want = jv.LRBatcher(jds, 2, crop=8, seed=1).sample_batch()
    assert_batches_equal(tv.LRBatcher(tds, 2, crop=8, seed=1).sample_batch(),
                         want)
