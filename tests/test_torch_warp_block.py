"""The port's block-gather ring warp (``ModelConfig(block_warp=True)``)
against cdfo_tpu's, on the CPU.

* ``flow_warp_ring_block_plain`` against the JAX ``flow_warp_ring_block``
  (its Pallas kernel in interpret mode) and against the port's own
  ``flow_warp_ring``, on the cases of ``tests/test_warp_block.py``: flows
  constant over 4x4 blocks with blocks fully and partly outside, the same
  with a mixed bottom band, and arbitrary flows. The patch form blends H
  then W where the 4-tap form weights each tap, so float32 results agree
  within rtol = atol = 2e-5 (the JAX test's bound); bfloat16 is held
  against bfloat16 within one rounding of the output.
* the per-block path choice: the bottom 4 rows and every block whose flows
  differ take the 4-tap form bit for bit.
* the engine with ``block_warp`` within 1 LSB of the JAX engine with
  ``block_warp`` and of the port's engine without it.
* the wrapper's refusals.

Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.infer.engine import BatchedStreamingEngine as JEngine
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.ops.warp_block import flow_warp_ring_block as j_block_warp
from cdfo_tpu.ops.warp_block import pad_ring_frame
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.ops import kernel_cases as kc
from cdfo_tpu_torch.ops import warp_block as wb
from cdfo_tpu_torch.ops.warp import _taps, flow_warp_ring


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = ("blocky", "mixed_bottom", "arbitrary")


def _case(case, l=3, h=16, w=32, c=8, b=2):
    """(frames, frame_idx, flow) as numpy: the inputs of
    ``tests/test_warp_block.py``."""
    rng = np.random.RandomState(0 if case != "arbitrary" else 1)
    frames = rng.rand(l, h, w, c).astype(np.float32)
    fidx = np.array([2, 0], np.int32)
    if case == "arbitrary":
        return frames, fidx, (rng.randn(b, h, w, 2) * 2.0).astype(np.float32)
    blk = (rng.randn(b, h // 4, w // 4, 2) * 3.0).astype(np.float32)
    blk[0, 0, 0] = (-50.0, 2.0)       # fully outside
    blk[0, 0, 1] = (-1.5, -1.5)       # partially valid corner
    blk[1, -1, -1] = (2.5, h - 1.2)   # partially valid bottom edge
    flow = np.repeat(np.repeat(blk, 4, 1), 4, 2)
    if case == "mixed_bottom":
        flow[:, h - 2:] = 0.0
    return frames, fidx, flow


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_block_warp_and_ring_warp(case):
    frames, fidx, flow = _case(case)
    ref = np.asarray(j_block_warp(pad_ring_frame(jnp.asarray(frames)),
                                  jnp.asarray(fidx), jnp.asarray(flow)))
    with torch.no_grad():
        got = wb.flow_warp_ring_block(t_(frames), t_(fidx), t_(flow))
        ring = flow_warp_ring(t_(frames), t_(fidx), t_(flow))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ring.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert np.abs(ref).max() > 0.5


@pytest.mark.parametrize("case", CASES)
def test_plain_in_bfloat16_matches_jax_in_bfloat16(case):
    frames, fidx, flow = _case(case)
    ref = j_block_warp(pad_ring_frame(jnp.asarray(frames, jnp.bfloat16)),
                       jnp.asarray(fidx), jnp.asarray(flow, jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        got = wb.flow_warp_ring_block(t_(frames).bfloat16(), t_(fidx),
                                      t_(flow).bfloat16())
    assert got.dtype == torch.bfloat16
    # both blend in float32 and round once: one ulp of values below 1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=2.0 ** -8)


def test_paths_are_chosen_per_block():
    """A block takes the patch path only if its 16 flows are equal and it
    is not in the bottom 4 rows; every other block is the 4-tap form bit
    for bit, and a patch block is the patch form bit for bit."""
    frames, fidx, flow = _case("mixed_bottom")
    flow[1, 5, 6, 0] += 1.0     # one pixel of block (1, 1) of image 1
    flow[0, 8:12, 20:24] = np.random.RandomState(2).randn(4, 4, 2)
    paths = wb.block_paths(t_(flow))
    assert paths.shape == (2, 4, 8) and paths.dtype == torch.bool
    assert not paths[:, -1].any()
    assert not paths[1, 1, 1] and not paths[0, 2, 5]
    assert int(paths.sum()) == 2 * 3 * 8 - 2
    # blocky flows with a blocky bottom band: the bottom still goes per pixel
    _, _, blocky = _case("blocky")
    assert wb.block_paths(t_(blocky))[:, :-1].all()
    assert not wb.block_paths(t_(blocky))[:, -1].any()
    with torch.no_grad():
        out, got_paths = wb.flow_warp_ring_block_plain(
            t_(frames), t_(fidx), t_(flow), return_paths=True)
        taps = _taps(t_(frames), t_(fidx), t_(flow))
        patch = wb._patch_blend(t_(frames), t_(fidx), t_(flow))
    assert torch.equal(got_paths, paths)
    pick = paths.repeat_interleave(4, 1).repeat_interleave(4, 2)
    assert torch.equal(out[~pick], taps[~pick])
    assert torch.equal(out[pick], patch[pick])
    # the two forms round differently, so a wrong choice shows bit for bit
    assert (patch[pick] != taps[pick]).any()
    # and on a non-constant block the patch form is another function
    assert (patch[1, 4:8, 4:8] - taps[1, 4:8, 4:8]).abs().max() > 1e-3


def test_kernel_cases_cover_every_path():
    g = torch.Generator().manual_seed(0)
    for case, lo, hi in (("blocky", 0.7, 0.8), ("mixed", 0.5, 0.75),
                         ("arbitrary", 0.0, 0.0)):
        ring, idx, flow = kc.warp_args(case, torch.bfloat16, g, (3, 2, 16, 32),
                                       device="cpu")
        share = wb.block_paths(flow).float().mean().item()
        assert lo <= share <= hi, (case, share)
        assert ring.shape == (3, 16, 32, 64) and idx.shape == (2,)


def test_wrapper_refusals():
    ring = torch.zeros(3, 8, 12, 64)
    idx = torch.zeros(2, dtype=torch.int64)
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiples of 4"):
            wb.flow_warp_ring_block(torch.zeros(3, 6, 12, 64), idx,
                                    torch.zeros(2, 6, 12, 2))
        with pytest.raises(ValueError, match="bad shapes"):
            wb.flow_warp_ring_block(ring, idx, torch.zeros(2, 8, 16, 2))
        with pytest.raises(ValueError, match="bad shapes"):
            wb.flow_warp_ring_block(ring, idx[:1], torch.zeros(2, 8, 12, 2))
    with pytest.raises(NotImplementedError, match="inference-only"):
        wb.flow_warp_ring_block(ring.requires_grad_(), idx,
                                torch.zeros(2, 8, 12, 2))


def test_card_route_checks_its_operands(monkeypatch):
    """What the kernel does not take is refused before any launch (the
    card's route, reached here by saying a CPU tensor is on the card)."""
    from cdfo_tpu_torch.ops import cuda_build as cb
    monkeypatch.setattr(cb, "on_card", lambda t, what: True)
    idx = torch.zeros(2, dtype=torch.int64)
    flow = torch.zeros(2, 8, 12, 2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="64 channels"):
            wb.flow_warp_ring_block(torch.zeros(3, 8, 12, 32), idx, flow)
        with pytest.raises(TypeError, match="one dtype"):
            wb.flow_warp_ring_block(torch.zeros(3, 8, 12, 64), idx,
                                    flow.bfloat16())
        with pytest.raises(ValueError, match="contiguous"):
            wb.flow_warp_ring_block(
                torch.zeros(3, 8, 64, 12).transpose(2, 3), idx, flow)
        with pytest.raises(TypeError, match="integer"):
            wb.flow_warp_ring_block(torch.zeros(3, 8, 12, 64), idx.float(),
                                    flow)


# -- the engine -----------------------------------------------------------------

NF, T, H, W = 32, 6, 16, 24


@pytest.fixture(scope="module")
def setup():
    d = np.zeros((1, 7, H, W, 1), np.float32)
    dm = np.zeros((1, 7, H, W, 2), np.float32)
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, mask_mode="expected",
                                  block_warp=True))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), d, dm, dm, d, d, d)
    params = jax.tree.map(np.array, params)
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    models = {}
    for block_warp in (True, False):
        models[block_warp] = CVSRV8(
            ModelConfig(nf=NF, scn_groups=1, block_warp=block_warp),
            generator=torch.Generator().manual_seed(0), device="cpu")
        models[block_warp].load_state_dict(from_flax(params), strict=True)
    return jmodel, params, models


@pytest.mark.parametrize("k", [1, 4])
def test_block_warp_engine_matches_jax_engine(setup, monkeypatch, k):
    """Also: ``warp_neighbours`` reaches the block warp once per step, with
    blocky flows above the bottom band, and launches no kernel on the CPU;
    without ``block_warp`` it never reaches it."""
    from cdfo_tpu_torch.models import cvsr
    jmodel, params, models = setup
    seen = []

    def spy(ring, idx, flow):
        seen.append(wb.block_paths(flow)[:, :-1].float().mean().item())
        return wb.flow_warp_ring_block(ring, idx, flow)

    monkeypatch.setattr(cvsr, "flow_warp_ring_block", spy)
    ref, _ = JEngine(jmodel, params, k=k).run_sequence(
        j_synthetic(t=T, h=H, w=W, seed=3))
    data = synthetic_sequence(t=T, h=H, w=W, seed=3)
    before = wb.flow_warp_ring_block.launches
    frames, _ = BatchedStreamingEngine(models[True], k=k).run_sequence(data)
    assert wb.flow_warp_ring_block.launches == before
    assert len(seen) == -(-T // k) and min(seen) == 1.0
    own, _ = BatchedStreamingEngine(models[False], k=k).run_sequence(data)
    assert len(seen) == -(-T // k)
    assert frames.shape == ref.shape == (T, 4 * H, 4 * W)
    for other in (ref, own):
        diff = np.abs(frames.astype(np.int32) - other.astype(np.int32))
        assert diff.max() <= 1, (k, diff.max(), (diff > 1).sum())
    assert frames.std() > 0
