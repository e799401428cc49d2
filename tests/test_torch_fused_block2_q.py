"""The port's int8 trunk (``ModelConfig(trunk_int8=True)``) against
cdfo_tpu's, in float32 on the CPU.

* ``quant_weight`` against the JAX one.
* ``scale_block_q_plain`` given the TPU kernel's step geometry against
  ``scale_block_hcw_q`` in interpret mode, as ``tests/test_fused_kernels.py``
  runs it (C = 8, rows = 4, wt = 128), with one and with several serial
  steps (the lagged scale) and several lane tiles. The int8 products are
  exact on both sides and the float steps are the same operations, so the
  two agree within 1e-5 of the largest output (found: 2e-7); a differing
  scale would move whole windows by a quantization step (1e-2).
* The plain version at the CUDA kernel's geometry within the JAX test's
  bound of the exact ``Block_`` (rel < 0.05, corr > 0.999).
* A step past the lagged scale: clipped by the TPU's scheme, quantized
  again at its own amax by the port's; elsewhere the two are equal.
* The clip counter, ``SCNetFast(use_int8)`` under ``from_flax(strict)``
  weights, the configuration's refusals.
* The five-flag port engine (the plain version at the TPU geometry) against
  the five-flag JAX engine: uint8 frames within 1 LSB (found: 1).

Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.infer.engine import BatchedStreamingEngine as JEngine
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.ops.fused_block2_q import fused_scale_block_q
from cdfo_tpu.ops.fused_block2_q import quant_weight as j_quant_weight
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.models.trunk_fast import SCNetFast
from cdfo_tpu_torch.ops import fused_block2_q as fq
from cdfo_tpu_torch.ops.fused_block2 import scale_block_plain


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def t_conv(k):
    """HWIO -> torch (out, in, kh, kw)."""
    return t_(np.transpose(k, (3, 2, 0, 1)))


def _case(seed, shape):
    """x and the Block_ weights of ``tests/test_fused_kernels.py``'s int8
    test: (numpy HWIO arguments of the JAX wrapper, the port's)."""
    r = np.random.RandomState(seed)
    c = shape[-1]
    cm = 4 * c

    def rnd(*s, scale=1.0):
        return (r.randn(*s) * scale).astype(np.float32)

    x = rnd(*shape)
    w1, b1 = rnd(3, 3, c, cm, scale=0.1), rnd(cm, scale=0.1)
    w2, b2 = rnd(3, 3, cm, c, scale=0.1), rnd(c, scale=0.1)
    kd, bd = rnd(1, 1, c, c, scale=0.3), rnd(c, scale=0.1)
    ku, bu = rnd(1, 1, c, c, scale=0.3), rnd(c, scale=0.1)
    jargs = (x, w1, b1, w2, b2, kd, bd, ku, bu)
    targs = (t_(x), t_conv(w1), t_(b1), t_conv(w2), t_(b2), t_conv(kd),
             t_(bd), t_conv(ku), t_(bu))
    return jargs, targs


def test_quant_weight_matches_jax():
    w = np.random.RandomState(0).randn(24, 72).astype(np.float32) * 0.1
    w[3] = 0.0   # an all-zero row takes the 1e-8 floor
    jq, js = j_quant_weight(jnp.asarray(w))
    q, s = fq.quant_weight(t_(w))
    assert q.dtype == torch.int8 and s.shape == (24, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # a conv weight is quantized per output channel over all its taps
    q4, s4 = fq.quant_weight(t_(w).reshape(24, 8, 3, 3))
    assert q4.shape == (24, 8, 3, 3)
    np.testing.assert_array_equal(q4.reshape(24, 72).numpy(), q.numpy())


@pytest.mark.parametrize("shape,rows,wt", [
    ((1, 16, 30, 8), 16, 128),   # one step per image
    ((2, 20, 30, 8), 4, 128),    # five serial steps, the last ragged rows
    ((1, 16, 260, 8), 8, 128),   # two steps, three lane tiles
])
def test_plain_at_tpu_geometry_matches_pallas_kernel(shape, rows, wt):
    jargs, targs = _case(3, shape)
    ref = np.asarray(fused_scale_block_q(*map(jnp.asarray, jargs), rows=rows,
                                         wt=wt))
    geo = fq.tpu_geometry(shape[2], rows=rows, wt=wt)
    with torch.no_grad():
        got = fq.scale_block_q_plain(*targs, geometry=geo).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_tpu_geometry_follows_the_jax_trunk():
    """One lane tile of the 128-padded width up to 1024 lanes, equal
    128-aligned tiles beyond (``cdfo_tpu.models.trunk_fast._pick_tiles``)."""
    from cdfo_tpu.models.trunk_fast import _pick_tiles
    for w in (24, 128, 480, 1024, 1030, 1920, 2500):
        geo = fq.tpu_geometry(w)
        assert (geo.rows, geo.cols) == (16, _pick_tiles(w)[0])
        assert (geo.z_extra, geo.y2_extra, geo.edge) == (1, 1, 6)
        assert not geo.requantize   # the TPU kernel clips


@pytest.mark.parametrize("geometry", [fq.KERNEL_GEOMETRY,
                                      fq.StepGeometry(4, 6)])
def test_plain_at_another_geometry_is_close_to_exact(geometry):
    """The JAX package's own bound between its int8 and exact kernels."""
    _, targs = _case(3, (1, 16, 30, 8))
    with torch.no_grad():
        exact = scale_block_plain(*targs).numpy()
        turbo = fq.scale_block_q(*targs, geometry=geometry).numpy()
    rel = np.abs(exact - turbo).max() / np.abs(exact).max()
    corr = np.corrcoef(exact.ravel(), turbo.ravel())[0, 1]
    assert rel < 0.05 and corr > 0.999, (rel, corr)
    assert rel > 1e-4   # and it is the quantized block, not the exact one


def test_geometry_changes_the_result():
    _, targs = _case(3, (1, 16, 30, 8))
    with torch.no_grad():
        a = fq.scale_block_q_plain(*targs)
        b = fq.scale_block_q_plain(*targs, geometry=fq.StepGeometry(4, 6))
    assert (a != b).any()


def test_clip_counts():
    """Rows that grow down the image outrun the lagged scale of the steps
    above them: values clip, and are counted once each."""
    _, targs = _case(5, (1, 32, 16, 8))
    with torch.no_grad():
        out, calm = fq.scale_block_q_plain(*targs, clip_counts=True)
        assert out.shape == targs[0].shape and calm.shape == (2,)
        x = targs[0].clone()
        x[:, 16:] *= 40.0
        _, grown = fq.scale_block_q(x, *targs[1:], clip_counts=True)
    assert calm.sum().item() < 0.001 * out.numel()
    assert grown[0].item() > 0 and grown[1].item() > 0
    # y1 has 4C values per pixel, y2 16C
    assert grown[0].item() <= 4 * out.numel()
    assert grown[1].item() <= 16 * out.numel()


def test_a_step_past_the_lagged_scale_is_quantized_again():
    """Where rows grow down the image past the lagged scale, the TPU's
    scheme clips them; the port's quantizes those steps again at their own
    amax. Steps that stay within it are the TPU scheme's to the bit (all of
    a calm image, the steps above the bright rows), the same values are
    counted, and the requantized block is far nearer the exact one."""
    _, targs = _case(5, (1, 32, 16, 8))
    clip = dataclasses.replace(fq.KERNEL_GEOMETRY, requantize=False)
    assert fq.KERNEL_GEOMETRY.requantize and not fq.tpu_geometry(16).requantize
    x = targs[0].clone()
    x[:, 16:] *= 40.0
    with torch.no_grad():
        calm, n_calm = fq.scale_block_q_plain(*targs, clip_counts=True)
        calm_clip = fq.scale_block_q_plain(*targs, geometry=clip)
        exact = scale_block_plain(x, *targs[1:])
        req, n_req = fq.scale_block_q(x, *targs[1:], clip_counts=True)
        clp, n_clp = fq.scale_block_q_plain(x, *targs[1:], geometry=clip,
                                            clip_counts=True)
    assert n_calm.sum().item() == 0 and torch.equal(calm, calm_clip)
    assert n_req[0].item() > 0 and n_req[1].item() > 0
    assert torch.equal(n_req, n_clp)
    assert torch.equal(req[:, :8], clp[:, :8])   # step 0: above the rows
    assert not torch.equal(req[:, 8:16], clp[:, 8:16])
    err_req = (req - exact).abs().max().item()
    err_clp = (clp - exact).abs().max().item()
    assert err_req < 0.1 * err_clp, (err_req, err_clp)
    assert err_req < 0.05 * exact.abs().max().item()


def test_wrapper_refusals():
    _, targs = _case(6, (1, 6, 8, 8))
    with torch.no_grad(), pytest.raises(ValueError, match="even"):
        fq.scale_block_q(torch.zeros(1, 6, 7, 8), *targs[1:])
    x = torch.zeros(1, 6, 8, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fq.scale_block_q(x, *targs[1:])


def test_kernel_weights_s8_layout():
    """Lane 4g + t of n-tile nt, k-tile kt holds n = 8nt + g and k = 32kt +
    16half + 4t .. 4t+3 as 8 consecutive bytes."""
    n, k = 16, 64
    w = torch.arange(n * k * 9, dtype=torch.int64).reshape(n, k, 3, 3)
    wq = (w % 251 - 125).to(torch.int8)
    p = fq.kernel_weights_s8(wq)
    assert p.shape == (9, k // 32, n // 8, 8, 4, 2, 4) and p.is_contiguous()
    for tap, kt, nt, g, t, half in ((0, 0, 0, 0, 0, 0), (4, 1, 1, 5, 3, 1),
                                    (8, 0, 1, 7, 2, 1)):
        k0 = 32 * kt + 16 * half + 4 * t
        want = wq[8 * nt + g, k0:k0 + 4, tap // 3, tap % 3]
        assert torch.equal(p[tap, kt, nt, g, t, half], want)


# -- the trunk, the model and the engine ---------------------------------------

NF, T, HE, WE = 32, 6, 16, 24
FIVE = dict(fused_trunk=True, fused_embed=True, fused_align=True,
            fused_egla=True, trunk_int8=True)


@pytest.fixture(scope="module")
def setup():
    """JAX weights of the unfused model (the EGLA mask excited) in a JAX
    model and a port model with the four fused flags and ``trunk_int8``;
    the port's int8 blocks walk the TPU geometry."""
    d = np.zeros((1, 7, HE, WE, 1), np.float32)
    dm = np.zeros((1, 7, HE, WE, 2), np.float32)
    base = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, mask_mode="expected"))
    params = jax.jit(base.init)(jax.random.PRNGKey(0), d, dm, dm, d, d, d)
    params = jax.tree.map(np.array, params)
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, mask_mode="expected",
                                  **FIVE))
    tmodel = CVSRV8(ModelConfig(nf=NF, scn_groups=1, **FIVE),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tmodel.load_state_dict(from_flax(params), strict=True)
    tmodel.recon_trunk.set_int8_geometry(fq.tpu_geometry(WE))
    return jmodel, params, tmodel


def test_int8_tree_is_the_exact_tree(setup):
    """``trunk_int8`` adds no parameter: the JAX int8 model initialises the
    tree of the exact one, and ``from_flax`` loads it strictly."""
    jmodel, params, tmodel = setup
    d = np.zeros((1, 7, HE, WE, 1), np.float32)
    dm = np.zeros((1, 7, HE, WE, 2), np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), d, dm, dm, d,
                            d, d)
    got = jax.tree_util.tree_map(lambda s: s.shape, shapes)
    want = jax.tree_util.tree_map(lambda a: a.shape, params)
    assert got == want
    assert set(tmodel.state_dict()) == set(from_flax(params))


def test_int8_trunk_runs_the_int8_block(setup, monkeypatch):
    """``SCNetFast(use_int8)`` keeps ``SCNetS``'s keys and sends every
    Block_ through ``scale_block_q`` with the geometry it was given."""
    from cdfo_tpu_torch.models import trunk_fast
    from cdfo_tpu_torch.models.trunk import SCNetS
    trunk = SCNetFast(8, 2, use_int8=True)
    assert set(trunk.state_dict()) == set(SCNetS(8, 2).state_dict())
    seen = []

    def spy(x, *params, packed=None, geometry=None):
        seen.append(geometry)
        return fq.scale_block_q(x, *params, packed=packed, geometry=geometry)

    monkeypatch.setattr(trunk_fast, "scale_block_q", spy)
    x = t_(np.random.RandomState(7).randn(1, 8, 12, 8).astype(np.float32))
    with torch.no_grad():
        at_kernel = trunk(x)
        trunk.set_int8_geometry(fq.StepGeometry(4, 6))
        other = trunk(x)
    assert seen == [None] * 6 + [fq.StepGeometry(4, 6)] * 6
    assert at_kernel.shape == x.shape and (at_kernel != other).any()


@pytest.mark.parametrize("k", [1, 4])
def test_five_flag_engine_matches_jax_engine(setup, k):
    jmodel, params, tmodel = setup
    ref, _ = JEngine(jmodel, params, k=k).run_sequence(
        j_synthetic(t=T, h=HE, w=WE, seed=3))
    frames, _ = BatchedStreamingEngine(tmodel, k=k).run_sequence(
        synthetic_sequence(t=T, h=HE, w=WE, seed=3))
    assert frames.shape == ref.shape == (T, 4 * HE, 4 * WE)
    diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, (k, diff.max(), (diff > 1).sum())
    assert frames.std() > 0


def test_config_takes_trunk_int8_under_fused_trunk_only():
    assert ModelConfig(compute_dtype=torch.bfloat16, **FIVE).trunk_int8
    assert ModelConfig(trunk_int8=True, fused_trunk=True).trunk_int8
    with pytest.raises(ValueError, match="fused_trunk"):
        ModelConfig(trunk_int8=True)
    with pytest.raises(NotImplementedError, match="scan trunk"):
        ModelConfig(scan_trunk=True, **FIVE)
