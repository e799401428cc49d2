"""The cdfo_tpu_torch streaming engine against cdfo_tpu's, on one set of
weights: uint8 frames within 1 LSB (float32 pipelines on both sides), for
k = 1 and k = 4, on a sequence whose ends exercise the clamped windows and
the max(1, i) prior rule."""
import jax
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.infer.engine import BatchedStreamingEngine as JEngine
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8

NF, T, H, W = 32, 9, 16, 24


@pytest.fixture(scope="module")
def setup():
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=2, mask_mode="expected"))
    d = np.zeros((1, 7, H, W, 1), np.float32)
    dm = np.zeros((1, 7, H, W, 2), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), d, dm, dm, d, d, d)
    params = jax.tree.map(np.array, params)
    # put one channel of the EGLA mask on, so the long-range attention
    # (the kernel's path) carries signal
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    tmodel = CVSRV8(ModelConfig(nf=NF, scn_groups=2),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tmodel.load_state_dict(from_flax(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("k", [1, 4])
def test_engine_matches_jax_engine(setup, k):
    jmodel, params, tmodel = setup
    ref, _ = JEngine(jmodel, params, k=k).run_sequence(
        j_synthetic(t=T, h=H, w=W, seed=3))
    frames, fps = BatchedStreamingEngine(tmodel, k=k).run_sequence(
        synthetic_sequence(t=T, h=H, w=W, seed=3))
    assert fps is None
    assert frames.shape == ref.shape == (T, 4 * H, 4 * W)
    assert frames.dtype == np.uint8
    diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, (k, diff.max(), (diff > 1).sum())
    assert frames.std() > 0


def test_timed_mode_gives_the_same_frames(setup):
    _, _, tmodel = setup
    data = synthetic_sequence(t=T, h=H, w=W, seed=3)
    eng = BatchedStreamingEngine(tmodel, k=4)
    frames, _ = eng.run_sequence(data)
    timed, fps = eng.run_sequence(data, collect_timing=True)
    np.testing.assert_array_equal(timed, frames)
    assert np.isfinite(fps) and fps > 0


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
def test_ring_geometry_matches(setup, k):
    """Ring capacity L and slot shift S, which place logical frame p in
    slot (p + S) mod L, are the JAX engine's."""
    jmodel, params, tmodel = setup
    ours = BatchedStreamingEngine(tmodel, k=k)
    ref = JEngine(jmodel, params, k=k)
    assert (ours._L, ours._S) == (ref._L, ref._S)


def test_untimed_mode_stages_the_next_step_before_reading_back(setup,
                                                               monkeypatch):
    """As the JAX engine: step j+1's inputs are prepared and uploaded
    before step j's frames are read back, so host work overlaps the
    device's."""
    _, _, tmodel = setup
    eng = BatchedStreamingEngine(tmodel, k=4)
    log = []
    stage, fetch = eng._stage, eng._fetch

    def logged_stage(data, j):
        log.append(("stage", j))
        return stage(data, j)

    def logged_fetch(sr8):
        wait, n = fetch(sr8), sum(e[0] == "read" for e in log)

        def read():
            log.append(("read", 4 * n))
            return wait()
        return read

    monkeypatch.setattr(eng, "_stage", logged_stage)
    monkeypatch.setattr(eng, "_fetch", logged_fetch)
    eng.run_sequence(synthetic_sequence(t=T, h=H, w=W, seed=3))
    assert log == [("stage", 0), ("stage", 4), ("read", 0), ("stage", 8),
                   ("read", 4), ("read", 8)]
