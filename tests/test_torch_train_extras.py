"""The rest of the port's training side, on the CPU:

- TensorBoard scalars: one epoch of ``train_loop`` with ``log_dir`` and an
  eval hook; the event file read back holds ``Train/Loss`` equal to the
  JSONL log's loss (its 5 decimals) and ``Eval/psnr`` equal to the hook's
  value; without the ``tensorboard`` package ``log_dir`` raises
  ``ImportError`` naming it.
- The soak's ``eval_psnr`` (``cdfo_tpu_torch/tools/soak.py``) against the
  JAX package's ``tools/soak.py::eval_psnr`` on ``cdfo_tpu``'s weights of
  a small CVSR_V8 (float32, the expected mask) carried across: within
  0.01 dB, and the bicubic PSNR beside it equal.
"""
import importlib.util
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.metrics.psnr_ssim import calculate_psnr as j_psnr
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.config import DataConfig, TrainConfig
from cdfo_tpu_torch.data.dataset import CVCPDataset
from cdfo_tpu_torch.data.io import make_synthetic_cvcp_tree
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.tools import soak
from cdfo_tpu_torch.train import loop as tloop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(nf=16, scn_groups=1, mask_mode="expected")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cvcp"))
    make_synthetic_cvcp_tree(root, num_seqs=1, frames=27, h=16, w=16,
                             structured=True)
    return root


def scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars(tree, tmp_path, monkeypatch):
    # tensorboard's own switch for running without TensorFlow (importing
    # TensorFlow, where it is installed, takes most of this test's time)
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))
    seen = []

    def eval_fn(state, epoch):
        seen.append(epoch)
        return {"psnr": 12.5 + epoch}

    train_cfg = TrainConfig(batch_size=1, val_interval=1,
                            ckpt_dir=str(tmp_path / "run"))
    data_cfg = DataConfig(frames_per_seq=27, crop_size=8)
    log_dir = str(tmp_path / "tb")
    tloop.train_loop(ModelConfig(**SMALL), data_cfg, train_cfg, tree,
                     num_epochs=2, steps_per_epoch=1, log_dir=log_dir,
                     eval_fn=eval_fn, device="cpu")
    _, log_path = tloop.run_dirs(train_cfg, data_cfg)
    logged = [json.loads(line)["loss"] for line in open(log_path)]
    got = scalars(log_dir)
    assert sorted(got) == ["Eval/psnr", "Train/Loss"]
    assert [s for s, _ in got["Train/Loss"]] == [0, 1]
    for (_, value), loss in zip(got["Train/Loss"], logged):
        assert abs(value - loss) <= 5e-6 + 1e-7 * abs(loss), (value, loss)
    assert got["Eval/psnr"] == [(0, 13.5), (1, 14.5)] and seen == [1, 2]


def test_log_dir_without_tensorboard_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="'tensorboard' package"):
        tloop.train_loop(ModelConfig(**SMALL),
                         DataConfig(frames_per_seq=27, crop_size=8),
                         TrainConfig(batch_size=1, val_interval=1,
                                     ckpt_dir=str(tmp_path / "run")),
                         tree, num_epochs=1, steps_per_epoch=1,
                         log_dir=str(tmp_path / "tb"), device="cpu")


def jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_soak_tool", os.path.join(ROOT, "tools", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_eval_psnr_matches_cdfo_tpu(tree):
    ds = CVCPDataset(tree, DataConfig(frames_per_seq=27))
    n, h, w = 7, 16, 16
    x = np.zeros((1, n, h, w, 1), np.float32)
    mv = np.zeros((1, n, h, w, 2), np.float32)
    jcfg = JModelConfig(**SMALL)
    params = jax.jit(JCVSRV8(jcfg).init)(jax.random.PRNGKey(2), x, mv, mv,
                                         x, x, x)
    want = jax_soak().eval_psnr(jcfg, params, ds, j_psnr)
    model = CVSRV8(ModelConfig(**SMALL), torch.Generator().manual_seed(0),
                   device="cpu")
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    got = soak.eval_psnr(model, ds)
    assert abs(got[0] - want[0]) <= 0.01, (got, want)
    assert got[1] == want[1]
    assert np.isfinite(got[0]) and 0 < got[1] < 100
