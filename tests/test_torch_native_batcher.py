"""The port's native batcher (``cdfo_tpu_torch/data/native.py`` over
``csrc/batcher.cpp``) against ``cdfo_tpu``'s (``cdfo_tpu/data/native.py``
over ``native/batcher.cpp``), and ``train_loop``'s choice of batcher.

``cdfo_tpu``'s library is built from ``native/batcher.cpp`` into this
module's temporary directory, and ``cdfo_tpu.data.native._LIB_PATH`` points
there while the module runs, so nothing under ``cdfo_tpu/`` is written.

- The port's batches equal ``cdfo_tpu``'s bit for bit, augment on and off,
  over two calls (the seed advances between them).
- At augment off on one sequence of exactly 7 frames with the crop the
  frame size (nothing drawn), they equal the port's ``TrainBatcher``'s to
  one float32 ulp (the C++ multiplies by 1/255 where numpy divides by 255).
- RA: the port's ``NativeBatcher`` refuses an RA dataset and its
  ``train_loop`` takes ``TrainBatcher`` there. ``cdfo_tpu``'s native
  sampler expands every config the LD way, so its RA batches differ from
  its ``TrainBatcher``'s in ``mvs0`` and ``mvs1`` (the recorded fault of
  the JAX package that the port does not copy).
- ``train_loop`` with its default batcher against ``cdfo_tpu``'s
  ``train_loop`` with its native library: two float32 CPU steps of a small
  CVSR_V8 (expected mask, so no noise is drawn) from the same weights,
  losses within 1e-4 relative; both loops draw one batch before the first
  step. Where the library cannot be built, ``train_loop`` raises.
"""
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

import cdfo_tpu.data.native as jnative
import cdfo_tpu.train.loop as jloop
from cdfo_tpu.config import DataConfig as JDataConfig
from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.config import TrainConfig as JTrainConfig
from cdfo_tpu.data.dataset import CVCPDataset as JDataset
from cdfo_tpu.data.dataset import TrainBatcher as JTrainBatcher
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.config import DataConfig, TrainConfig
from cdfo_tpu_torch.data import native
from cdfo_tpu_torch.data.dataset import CVCPDataset, TrainBatcher
from cdfo_tpu_torch.data.io import make_synthetic_cvcp_tree
from cdfo_tpu_torch.train import loop as tloop

KEYS = ("lrs", "mvs0", "mvs1", "pms", "rms", "ufs", "hr")
SMALL = dict(nf=16, scn_groups=1, mask_mode="expected")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """``cdfo_tpu``'s NativeBatcher on a library built here from
    ``native/batcher.cpp`` with ``tools/build_native.sh``'s flags."""
    lib = tmp_path_factory.mktemp("jax_native") / "_native.so"
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native",
                       "batcher.cpp")
    subprocess.check_call(["g++", "-O3", "-march=native", "-fopenmp",
                           "-shared", "-fPIC", src, "-o", str(lib)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(lib))
        mp.setattr(jnative, "_lib", None)
        yield jnative


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cvcp_native"))
    make_synthetic_cvcp_tree(root, num_seqs=3, frames=10, h=24, w=24)
    return root


def both_datasets(root, cfg="LD", frames=10):
    j = JDataset(root, JDataConfig(coding_cfg=cfg, frames_per_seq=frames,
                                   zero_mvl1_in_train=cfg == "LD"))
    t = CVCPDataset(root, DataConfig(coding_cfg=cfg, frames_per_seq=frames,
                                     zero_mvl1_in_train=cfg == "LD"))
    return j, t


@pytest.mark.parametrize("augment", [False, True])
def test_native_batches_equal_cdfo_tpu_bit_for_bit(jax_native, tree, augment):
    jds, tds = both_datasets(tree)
    jb = jax_native.NativeBatcher(jds, 3, crop=16, seed=5, augment=augment)
    tb = native.NativeBatcher(tds, 3, crop=16, seed=5, augment=augment)
    first = None
    for _ in range(2):
        want, got = jb.sample_batch(), tb.sample_batch()
        assert sorted(got) == sorted(want)
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if first is None:
            first = got
    assert not np.array_equal(first["lrs"], got["lrs"])  # the seed advances
    assert tb.seed == 5 + 2 * native.SEED_STEP


def test_native_equals_train_batcher_where_nothing_is_drawn(tmp_path):
    root = str(tmp_path)
    make_synthetic_cvcp_tree(root, num_seqs=1, frames=7, h=16, w=16)
    ds = CVCPDataset(root, DataConfig(frames_per_seq=7))
    nat = native.NativeBatcher(ds, 2, crop=16, augment=False).sample_batch()
    ref = TrainBatcher(ds, 2, crop=16, augment=False).sample_batch()
    for k in KEYS:
        assert nat[k].shape == ref[k].shape, k
        np.testing.assert_array_max_ulp(nat[k], ref[k], maxulp=1)
    assert np.isinf(ref["mvs0"]).sum() == 0


def ra_tree(root):
    """An RA tree whose L1 field points forward (+1), unlike its L0 field
    (-1), with some unavailable (-99) L1 entries, as an RA stream has."""
    names = make_synthetic_cvcp_tree(root, num_seqs=1, frames=7, h=16, w=16,
                                     cfg="RA")
    r = np.random.RandomState(3)
    pri = os.path.join(root, "Coding_Priors", "RA", "QP37",
                       f"RA_{names[0]}_32F_QP37.priors", "MV_l1")
    for f in range(7):
        mv = np.zeros((16, 16, 3), np.int16)
        mv[..., :2] = r.randint(-32, 32, (16, 16, 2))
        mv[..., 2] = np.where(r.rand(16, 16) < 0.2, -99, 1)
        np.save(os.path.join(pri, "%05d_mvl1.npy" % f), mv)
    return root


def test_ra_native_refused_and_cdfo_tpu_native_ra_differs(jax_native,
                                                           tmp_path,
                                                           monkeypatch):
    root = ra_tree(str(tmp_path / "ra"))
    jds, tds = both_datasets(root, "RA", frames=7)
    with pytest.raises(ValueError, match="RA"):
        native.NativeBatcher(tds, 2, crop=16)
    # the port's train_loop takes TrainBatcher for RA
    def refuse(*args, **kwargs):
        raise AssertionError("NativeBatcher used for RA")

    monkeypatch.setattr(native, "NativeBatcher", refuse)
    state = tloop.train_loop(
        ModelConfig(**SMALL),
        DataConfig(coding_cfg="RA", frames_per_seq=7, crop_size=8,
                   zero_mvl1_in_train=False),
        TrainConfig(batch_size=1, val_interval=100,
                    ckpt_dir=str(tmp_path / "run")),
        root, num_epochs=1, steps_per_epoch=1, device="cpu")
    assert state.step == 1
    # cdfo_tpu: its native sampler expands RA the LD way
    nat = jax_native.NativeBatcher(jds, 2, crop=16, augment=False)
    py = JTrainBatcher(jds, 2, crop=16, augment=False)
    bn, bp = nat.sample_batch(), py.sample_batch()
    for k in ("lrs", "pms", "rms", "ufs", "hr"):
        np.testing.assert_array_max_ulp(bn[k], bp[k], maxulp=1)
    for k in ("mvs0", "mvs1"):
        assert not np.allclose(np.nan_to_num(bn[k]), np.nan_to_num(bp[k])), k
    # the port's TrainBatcher is cdfo_tpu's, RA expansion included
    tb = TrainBatcher(tds, 2, crop=16, augment=False).sample_batch()
    for k in KEYS:
        np.testing.assert_array_equal(tb[k], bp[k], err_msg=k)


def test_train_loop_default_batcher_matches_cdfo_tpu_native(jax_native,
                                                            tree, tmp_path,
                                                            monkeypatch):
    jax_losses, init = [], {}
    real_create, real_step = jloop.create_train_state, jloop.train_step

    def create(model, cfg, sample, **kw):
        state = real_create(model, cfg, sample, **kw)
        init["params"] = jax.tree.map(np.asarray, state.params)
        return state

    def step(state, batch, rng):
        state, loss = real_step(state, batch, rng)
        jax.debug.callback(lambda v: jax_losses.append(float(v)), loss)
        return state, loss

    monkeypatch.setattr(jloop, "create_train_state", create)
    monkeypatch.setattr(jloop, "train_step", step)
    jloop.train_loop(JModelConfig(**SMALL),
                     JDataConfig(frames_per_seq=10, crop_size=8),
                     JTrainConfig(batch_size=2, val_interval=100,
                                  ckpt_dir=str(tmp_path / "jax")),
                     tree, num_epochs=1, steps_per_epoch=2, use_mesh=False)
    assert len(jax_losses) == 2

    losses = []
    weights = from_flax(init["params"])
    state = tloop.train_loop(
        ModelConfig(**SMALL), DataConfig(frames_per_seq=10, crop_size=8),
        TrainConfig(batch_size=2, val_interval=100,
                    ckpt_dir=str(tmp_path / "port")),
        tree, num_epochs=1, steps_per_epoch=2, device="cpu",
        on_start=lambda s: s.model.load_state_dict(weights),
        on_step=lambda s, loss: losses.append(loss.item()))
    assert state.step == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)


def test_train_loop_raises_where_the_library_cannot_be_built(tree, tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.available()
    args = (ModelConfig(**SMALL), DataConfig(frames_per_seq=10, crop_size=8),
            TrainConfig(batch_size=1, val_interval=100,
                        ckpt_dir=str(tmp_path / "run")), tree)
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        tloop.train_loop(*args, num_epochs=1, steps_per_epoch=1,
                         device="cpu")
    state = tloop.train_loop(*args, num_epochs=1, steps_per_epoch=1,
                             device="cpu", use_native_batcher=False)
    assert state.step == 1
