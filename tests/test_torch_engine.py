"""The cdfo_tpu_torch streaming engine against cdfo_tpu's, on one set of
weights: uint8 frames within 1 LSB (float32 pipelines on both sides), for
k = 1 and k = 4, on a sequence whose ends exercise the clamped windows and
the max(1, i) prior rule; and under the sampled EGLA mask with the same
gumbel draws injected into both."""
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_sampled_mask_engine_matches_jax_engine(setup):
    """The JAX engine's two jitted functions each read one gumbel draw,
    fixed when they trace (``jax.random.uniform`` patched): the bootstrap's
    of shape (k + 6, H, W, nf), every step's of (k, H, W, nf). The port's
    engine is fed the same two through ``compensate_frames(gumbel_u=)``.
    Two channels of the EGLA mask are put on alike (channel 3's, as in
    ``setup``, and channel 5's), so that the noise decides pixel by pixel
    which one passes 0.5. Under random weights the frames move by 1 LSB at
    most when the draws change, so the bootstrap's compensated features
    are also held against the JAX engine's (its quad-packed ring entries):
    within 1e-5 of their largest value, where other draws move them by
    more than 1e-2."""
    _, params, _ = setup
    params = jax.tree.map(np.copy, params)
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][5] += 10.0
    k, t = 2, 5
    r = np.random.RandomState(11)
    draws = {m: np.maximum(r.rand(m, H, W, NF), np.finfo(np.float32).tiny)
             .astype(np.float32) for m in (k + 6, k)}
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape[1:]) == (H, W, NF) and shape[0] in draws:
            return jax.numpy.asarray(draws[shape[0]])
        return real_uniform(key, shape, *args, **kwargs)

    cfg = dict(nf=NF, scn_groups=2, mask_mode="sample")
    jeng = JEngine(JCVSRV8(JModelConfig(**cfg)), params, k=k)
    jdata = j_synthetic(t=t, h=H, w=W, seed=3)
    boot = jeng._frame_inputs(jdata, [0, 0, 0, 0, 0, 0, 1, 2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        ref, _ = jeng.run_sequence(jdata)
        ref_fi = np.asarray(jeng._boot(params, *boot,
                                       jax.random.PRNGKey(0))[1])
    ref_fi = ref_fi[:, 4:4 + H, 4:4 + W, :NF]   # quad_pack's first tap
    tmodel = CVSRV8(ModelConfig(**cfg),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tmodel.load_state_dict(from_flax(params))
    data = synthetic_sequence(t=t, h=H, w=W, seed=3)

    def run(draw):
        eng = BatchedStreamingEngine(tmodel, k=k)
        eng._compensate = lambda lrs, *rest: tmodel.compensate_frames(
            lrs, *rest, gumbel_u=torch.from_numpy(draw(lrs.shape[0])))
        return eng.run_sequence(data)[0]

    frames = run(lambda m: draws[m])
    diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, (diff.max(), (diff > 1).sum())
    scale = np.abs(ref_fi).max()
    with torch.no_grad():
        for u, near in ((draws[k + 6], True), (draws[k + 6][::-1], False)):
            fi = tmodel.compensate_frames(
                *(torch.from_numpy(a) for a in boot),
                gumbel_u=torch.from_numpy(u.copy()))[1].numpy()
            err = np.abs(fi - ref_fi).max() / scale
            assert (err <= 1e-5) if near else (err > 1e-2), (near, err)
    seeded = BatchedStreamingEngine(
        tmodel, k=k, generator=torch.Generator().manual_seed(4))
    a, b = seeded.run_sequence(data)[0], seeded.run_sequence(data)[0]
    np.testing.assert_array_equal(a, b)
