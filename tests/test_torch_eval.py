"""The port's eval path against cdfo_tpu's, on the CPU.

The numpy copies (``metrics/matlab.py``, ``metrics/psnr_ssim.py``,
``data/io.py::load_eval_sequence``) equal their originals on seeded
inputs. The port's ``StreamingInferencer`` (float32, expected mask) gives
uint8 frames within 1 LSB of cdfo_tpu's on the same ``from_flax`` weights
(CVSR_V8 nf 16, 1 trunk group, 5 frames of 16x24), and of the port's own
engine. A released-checkpoint-style ``state_dict`` loads by name, its dead
keys dropped. The trainer's eval hook, ``test_sr``, ``eval_jctvc``,
``int8_delta`` and ``gumbel_variance`` run in process on tiny configs.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.data import io as jio
from cdfo_tpu.infer.pipeline import StreamingInferencer as JInferencer
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.metrics import matlab as jmatlab
from cdfo_tpu.metrics import psnr_ssim as jps
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import (from_flax, load_reference_checkpoint,
                                   load_reference_state_dict)
from cdfo_tpu_torch.config import DataConfig, TrainConfig
from cdfo_tpu_torch.data import io as tio
from cdfo_tpu_torch.infer import (BatchedStreamingEngine, StreamingInferencer,
                                  synthetic_sequence)
from cdfo_tpu_torch.metrics import matlab as tmatlab
from cdfo_tpu_torch.metrics import psnr_ssim as tps
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.tools import eval_jctvc, gumbel_variance, int8_delta
from cdfo_tpu_torch.tools import test_sr
from cdfo_tpu_torch.train import loop as tloop

NF, T, H, W = 16, 5, 16, 24
SEQ = "Johnny_320x184_600F.yuv"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    return ModelConfig(nf=NF, scn_groups=1, **kw)


def tiny_model(sd=None, **kw):
    model = CVSRV8(tiny_cfg(**kw), torch.Generator().manual_seed(0),
                   device="cpu")
    if sd is not None:
        model.load_state_dict(sd)
    return model


# -- the numpy copies ---------------------------------------------------------

@pytest.mark.parametrize("scale,aa", [(0.25, True), (0.5, False), (2.0, True)])
def test_imresize_equals_the_original(scale, aa):
    img = np.random.RandomState(0).rand(37, 22)
    np.testing.assert_array_equal(tmatlab.imresize(img, scale, aa),
                                  jmatlab.imresize(img, scale, aa))


def test_gaussian_and_imfilter_equal_the_originals():
    img = np.random.RandomState(1).rand(20, 17)
    k = tmatlab.fspecial_gaussian(7, 7 / 6)
    np.testing.assert_array_equal(k, jmatlab.fspecial_gaussian(7, 7 / 6))
    for mode in ("edge", "constant"):
        np.testing.assert_array_equal(tmatlab.imfilter(img, k, mode),
                                      jmatlab.imfilter(img, k, mode))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_colour_conversions_equal_the_originals(dtype):
    r = np.random.RandomState(2)
    img = r.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) / 255.0
    for name in ("rgb2ycbcr", "bgr2ycbcr"):
        for y_only in (False, True):
            np.testing.assert_array_equal(
                getattr(tps, name)(img, y_only), getattr(jps, name)(img, y_only))
    for name in ("ycbcr2rgb", "ycbcr2bgr"):
        np.testing.assert_array_equal(getattr(tps, name)(img),
                                      getattr(jps, name)(img))
    full = r.randint(0, 256, (9, 11, 3)).astype(np.float64)
    np.testing.assert_array_equal(tps.to_y_channel(full),
                                  jps.to_y_channel(full))


@pytest.mark.parametrize("y", [False, True])
def test_psnr_and_ssim_equal_the_originals(y):
    r = np.random.RandomState(3)
    a = r.randint(0, 256, (40, 36, 3)).astype(np.float64)
    b = np.clip(a + r.randn(*a.shape) * 9, 0, 255)
    for fn in ("calculate_psnr", "calculate_ssim"):
        for crop in (0, 4):
            assert getattr(tps, fn)(a, b, crop, test_y_channel=y) == \
                getattr(jps, fn)(a, b, crop, test_y_channel=y)
    assert tps.calculate_psnr(a, a, 4) == jps.calculate_psnr(a, a, 4)


def _write_frames(root, name, frames):
    for i, f in enumerate(frames):
        tio.write_gray(os.path.join(root, name, "%05d.png" % i), f)


def test_sequence_drivers_and_tof_equal_the_originals(tmp_path):
    """cal_psnr_ssim, cal_psnr_ssim_tof and the CVCP driver over a PNG tree
    (tOF needs cv2)."""
    pytest.importorskip("cv2")
    r = np.random.RandomState(4)
    gt = r.randint(0, 256, (3, 48, 40)).astype(np.uint8)
    sr = np.clip(gt + r.randn(*gt.shape) * 6, 0, 255).astype(np.uint8)
    name = "seq_003F"   # the CVCP driver reads the frame count off the name
    _write_frames(str(tmp_path / "sr"), name + ".png", sr)
    _write_frames(str(tmp_path / "gt"), name, gt)
    args = (str(tmp_path / "sr") + "/", [name + ".png"], [name],
            str(tmp_path / "gt") + "/")
    assert tps.cal_psnr_ssim(*args, num_frames=3) == \
        jps.cal_psnr_ssim(*args, num_frames=3)
    assert tps.cal_psnr_ssim_tof(*args, num_frames=3) == \
        jps.cal_psnr_ssim_tof(*args, num_frames=3)
    assert tps.cal_psnr_ssim_tof_cvcp(*args) == jps.cal_psnr_ssim_tof_cvcp(*args)
    assert tps.calculate_tof(gt[1], sr[1], gt[0], sr[0]) == \
        jps.calculate_tof(gt[1], sr[1], gt[0], sr[0])


def test_load_eval_sequence_equals_the_original(tmp_path):
    """On a 270-row tree (padded to 272 on load) with int16 residuals."""
    eval_jctvc.write_synthetic_tree(str(tmp_path), [SEQ], 3, size=(270, 16))
    lr_dir = str(tmp_path / "LD/qp37/lr_grey" / SEQ)
    side = str(tmp_path / "LD/qp37/sideInfo_QP37" / SEQ[:-4])
    ours = tio.load_eval_sequence(lr_dir, side, 2)
    ref = jio.load_eval_sequence(lr_dir, side, 2)
    assert ours.lr.shape == (2, 272, 16)
    for f in ("lr", "pm", "rm", "uf", "mvl0", "mvl1"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))


# -- the inferencer and checkpoints ----------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    """cdfo_tpu's StreamingInferencer on seeded weights: (params, frames),
    the EGLA mask of one channel put on so that its attention carries
    signal."""
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, mask_mode="expected"))
    d = np.zeros((1, 7, H, W, 1), np.float32)
    dm = np.zeros((1, 7, H, W, 2), np.float32)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), d, dm, dm, d, d, d))
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    frames, _ = JInferencer(jmodel, params).run_sequence(
        j_synthetic(t=T, h=H, w=W, seed=3))
    return params, frames


def _lsb(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32)).max()


def test_inferencer_matches_jax_and_the_engine(jax_run):
    params, ref = jax_run
    model = tiny_model(from_flax(params))
    data = synthetic_sequence(t=T, h=H, w=W, seed=3)
    frames, fps = StreamingInferencer(model).run_sequence(data)
    assert fps is None and frames.dtype == np.uint8
    assert frames.shape == ref.shape == (T, 4 * H, 4 * W)
    assert _lsb(frames, ref) <= 1 and frames.std() > 0
    engine, _ = BatchedStreamingEngine(model, k=2).run_sequence(data)
    assert _lsb(frames, engine) <= 1
    timed, fps = StreamingInferencer(model).run_sequence(
        data, collect_timing=True)
    np.testing.assert_array_equal(timed, frames)
    assert np.isfinite(fps) and fps > 0


def test_reference_checkpoint_loads_by_name(jax_run, tmp_path):
    """A .pth holding the reference's keys (the port's names) and dead
    keys of never-called reference submodules loads into the model
    ``from_flax`` gives; an unknown or a missing key raises naming it."""
    params, _ = jax_run
    sd = from_flax(params)
    dead = {"MV_deform_align.fusion_in.0.weight": torch.ones(2),
            "MV_deform_align.conv_offset_mask.bias": torch.ones(3),
            "transformer_feature_extraction.path1.adaptiveWeight":
                torch.ones(1)}
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {**sd, **dead}}, path)
    model = tiny_model()
    assert sorted(load_reference_checkpoint(model, path)) == sorted(dead)
    want = tiny_model(sd).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(KeyError, match="conv_first.extra"):
        load_reference_state_dict(model, {**sd, "conv_first.extra": 1.0})
    short = {k: v for k, v in sd.items() if k != "conv_last.bias"}
    with pytest.raises(KeyError, match="conv_last.bias"):
        load_reference_state_dict(model, short)
    with pytest.raises(ValueError, match="conv_last.bias"):
        load_reference_state_dict(model, {**sd, "conv_last.bias":
                                          torch.zeros(2)})


# -- the trainer's eval hook and the tools ----------------------------------

@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """(lr_dir, side_dir, gt_dir) of a 3-frame 16x24 eval sequence, and the
    tree's root."""
    root = str(tmp_path_factory.mktemp("jctvc"))
    eval_jctvc.write_synthetic_tree(root, [SEQ], 3, size=(H, W))
    return (os.path.join(root, "LD/qp37/lr_grey", SEQ),
            os.path.join(root, "LD/qp37/sideInfo_QP37", SEQ[:-4]),
            os.path.join(root, "gt_Y", dict(eval_jctvc.SEQUENCES)[SEQ]),
            root)


def test_train_loop_calls_the_eval_hook_on_the_new_weights(eval_tree,
                                                           tmp_path):
    """One epoch of a sampled-mask model through ``train_loop``: the hook
    runs after the checkpoint and scores the weights the step wrote
    (as an expected-mask inferencer over them scores them)."""
    lr_dir, side, gt_dir, _ = eval_tree
    root = str(tmp_path / "cvcp")
    tio.make_synthetic_cvcp_tree(root, num_seqs=1, frames=9, h=H, w=W)
    cfg = tiny_cfg(mask_mode="sample")
    hook = tloop.make_eval_fn(cfg, lr_dir, side, gt_dir, device="cpu")
    seen = []

    def eval_fn(state, epoch):
        seen.append((epoch, hook(state, epoch),
                     {k: v.clone() for k, v in
                      state.model.state_dict().items()}))

    state = tloop.train_loop(
        cfg, DataConfig(frames_per_seq=9, crop_size=8),
        TrainConfig(batch_size=1, val_interval=1, ckpt_dir=str(tmp_path)),
        root, num_epochs=1, steps_per_epoch=1, eval_fn=eval_fn, device="cpu")
    assert state.step == 1 and len(seen) == 1
    epoch, metrics, weights = seen[0]
    assert epoch == 1
    frames, _ = StreamingInferencer(tiny_model(weights)).run_sequence(
        tio.load_eval_sequence(lr_dir, side, 32))
    psnr, ssim = test_sr.frame_scores(frames, gt_dir)
    assert metrics == {"psnr": psnr, "ssim": ssim}
    assert 0 < psnr < 100 and 0 <= ssim <= 1


def test_test_sr_runs_in_process(eval_tree, tmp_path, jax_run):
    """``evaluate`` on a tiny model with a .pth checkpoint, fps and the
    feature dump, then the CLI on the eval tree (default model, CPU)."""
    lr_dir, side, gt_dir, _ = eval_tree
    params, ref = jax_run
    path = str(tmp_path / "w.pth")
    torch.save(from_flax(params), path)
    out = test_sr.evaluate(
        tiny_cfg(), synthetic_sequence(t=T, h=H, w=W, seed=3), "cpu",
        ckpt=path, save_dir=str(tmp_path / "sr"), fps=True,
        dump_features=str(tmp_path / "fea"))
    assert _lsb(out["frames"], ref) <= 1 and out["fps"] > 0
    assert len(os.listdir(tmp_path / "fea")) == 7
    assert tio.read_gray(str(tmp_path / "sr" / "00004.png")).shape == \
        (4 * H, 4 * W)
    out = test_sr.main(["--lr-dir", lr_dir, "--side-dir", side, "--gt-dir",
                        gt_dir, "--cpu", "--save-dir", str(tmp_path / "cli")])
    assert 0 < out["psnr"] < 100 and 0 <= out["ssim"] <= 1
    with pytest.raises(NotImplementedError, match="1.6"):
        test_sr.main(["--synthetic", "--cpu", "--scan-trunk"])


def test_eval_jctvc_runs_in_process(eval_tree, tmp_path, capsys):
    _, _, _, root = eval_tree
    log = str(tmp_path / "log.txt")
    results = eval_jctvc.main(["--test-root", root, "--cpu", "--sequences",
                               SEQ, "--max-frames", "2", "--out",
                               str(tmp_path / "out"), "--log", log, "--fps"])
    assert [r["seq"] for r in results] == [SEQ]
    assert 0 < results[0]["psnr"] < 100 and results[0]["fps"] > 0
    lines = [json.loads(x) for x in open(log)]
    assert lines[0] == results[0] and "mean" in lines[1]
    assert len(os.listdir(tmp_path / "out" / "LD_QP37" / SEQ)) == 2
    assert '"mean"' in capsys.readouterr().out


def test_int8_delta_runs_in_process():
    """Two steps; on the CPU the exact trunk is the plain one's math."""
    out = int8_delta.run(tiny_cfg(), 2, "cpu")
    assert out["exact"] == out["plain"]
    assert abs(out["int8_delta"]) < 0.05 and abs(out["tpu_delta"]) < 0.05
    assert sorted(out["bf16"]) == ["exact", "int8", "plain"]
    assert all(np.isfinite(v) for v in out["bf16"].values())
    for clips in (out["clips"], out["tpu_clips"]):
        assert clips[2] > 0 and clips[3] == 4 * clips[2]
        assert 0 <= clips[0] <= clips[2] and 0 <= clips[1] <= clips[3]


def test_gumbel_variance_runs_in_process():
    out = gumbel_variance.run(tiny_cfg(mask_mode="sample"), 2, 2, "cpu")
    assert np.isfinite(out["expected"]) and len(out["samples"]) == 2
    assert out["samples"][0] != out["samples"][1]
