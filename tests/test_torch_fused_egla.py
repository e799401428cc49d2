"""The port's fused EGLA (``ModelConfig(fused_egla=True)``) against
cdfo_tpu's, in float32 on the CPU.

* ``eg1_rows_plain`` and ``eg2_local_fuse_plain`` against the JAX Pallas
  kernels they port, run as the JAX suite runs them on the CPU (interpret
  mode), at narrow widths (C = 16): eg1 at H = 24 with ``rows=16``, so the
  TPU grid takes two steps, the H-band's halo crosses a block and the
  padded tail is cut off, with a general q projection and a nonzero band
  bias; eg2 at (2, 16, 24, C). eg2 refuses H or W off the 8x8 windows.
* ``EGLA(fused=True)`` against JAX's fused EGLA on ``from_flax`` weights,
  with the residual mask zero and one-hot, and against the port's unfused
  EGLA.
* The port's engine with all four fused flags against the JAX engine with
  all four: uint8 frames within 1 LSB, the mask excited.
* ``kernel_cases.excite_egla_mask``: one mask bit per frame.
* The config: four flags build, the other strategies still raise.

Inputs come from numpy seeds; kernels agree within 1e-4 of the reference's
largest magnitude (the JAX suite's rule), the modules within 2e-4 (the JAX
fused-EGLA test's bound).
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
from cdfo_tpu.models.attention import EGLA as JEGLA
from cdfo_tpu.ops import fused_egla as jfe
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.models.attention import EGLA
from cdfo_tpu_torch.ops import fused_egla as fe
from cdfo_tpu_torch.ops import kernel_cases as kc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C = 16


def assert_close(port, ref, rel=1e-4):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def rand(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype(np.float32)


# -- the kernels' plain versions --------------------------------------------------

EG1 = ("x", "aq", "cq", "bv", "cv", "h9")
EG2 = ("x", "long", "wq", "bq", "wv", "bv", "mask_inv", "fa", "fb", "bf")


def test_eg1_rows_plain_matches_pallas_kernel():
    r = np.random.RandomState(0)
    m, h, w, rows = 2, 24, 20, 16
    a = dict(x=rand(r, m, h, w, C), aq=rand(r, m, C, C, scale=0.15),
             cq=rand(r, m, C, scale=0.1), bv=rand(r, C, C, scale=0.25),
             cv=rand(r, 1, C, scale=0.1), h9=rand(r, 10, scale=0.3))
    assert abs(a["h9"][9]) > 0.01
    # the TPU kernel takes H padded to a multiple of rows (any tail values)
    xp = np.pad(a["x"], ((0, 0), (0, (-h) % rows), (0, 0), (0, 0)),
                constant_values=5.0)
    qc_ref, vr_ref = jfe.eg1_rows(
        jnp.asarray(xp), *(jnp.asarray(a[k]) for k in EG1[1:]), img_h=h,
        rows=rows)
    qc, vr = fe.eg1_rows_plain(*(t_(a[k]) for k in EG1))
    assert_close(qc, np.asarray(qc_ref)[:, :h])
    assert_close(vr, np.asarray(vr_ref)[:, :h])


def _eg2_case(r, m, h, w):
    return dict(x=rand(r, m, h, w, C), long=rand(r, m, h, w, C),
                wq=rand(r, C, C, scale=0.15), bq=rand(r, 1, C, scale=0.1),
                wv=rand(r, C, C, scale=0.25), bv=rand(r, 1, C, scale=0.1),
                mask_inv=(r.rand(m, C) < 0.5).astype(np.float32),
                fa=rand(r, C, C, scale=0.2), fb=rand(r, C, C, scale=0.2),
                bf=rand(r, 1, C, scale=0.1))


def test_eg2_local_fuse_plain_matches_pallas_kernel():
    m, h, w = 2, 16, 24
    a = _eg2_case(np.random.RandomState(1), m, h, w)
    ref = jfe.eg2_local_fuse(*(jnp.asarray(a[k]) for k in EG2), img_h=h)
    assert_close(fe.eg2_local_fuse_plain(*(t_(a[k]) for k in EG2)), ref)


@pytest.mark.parametrize("h,w", [(20, 24), (16, 20)])
def test_eg2_refuses_a_ragged_window_on_the_cpu(h, w):
    a = _eg2_case(np.random.RandomState(2), 1, h, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        fe.eg2_local_fuse(*(t_(a[k]) for k in EG2))


# -- the module ---------------------------------------------------------------------

B, HM, WM = 2, 24, 32


def _egla_params(excite):
    r = np.random.RandomState(3)
    res, x = rand(r, B, HM, WM, C, scale=0.3), rand(r, B, HM, WM, C,
                                                     scale=0.5)
    params = jax.tree.map(np.array, JEGLA(C, mask_mode="expected").init(
        jax.random.PRNGKey(0), res, x))
    p = params["params"]
    p["directW1_bias"] = np.float32(0.07)
    p["directH1_bias"] = np.float32(-0.05)
    if excite:
        p["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    return params, res, x


@pytest.mark.parametrize("excite", [False, True])
def test_fused_egla_matches_jax_fused_egla(excite):
    params, res, x = _egla_params(excite)
    ref = jax.jit(JEGLA(C, mask_mode="expected", fused=True).apply)(
        params, res, x)
    tmod = EGLA(C, fused=True)
    tmod.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        bits = tmod.residual_mask(t_(res)).sum(dim=1)
        out = tmod(t_(res), t_(x))
    assert bits.tolist() == ([1.0] * B if excite else [0.0] * B)
    assert_close(out, ref, rel=2e-4)


def test_fused_egla_matches_unfused_egla():
    params, res, x = _egla_params(True)
    out = {}
    for fused in (False, True):
        tmod = EGLA(C, fused=fused)
        tmod.load_state_dict(from_flax(params), strict=True)
        with torch.no_grad():
            out[fused] = tmod(t_(res), t_(x))
    assert_close(out[True], out[False].numpy(), rel=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_egla_hands_the_kernels_what_they_take(monkeypatch, dtype):
    """The checks a CUDA tensor meets in the wrappers (contiguous operands
    of x's dtype, float32 taps, the shapes), applied on the CPU to what
    ``EGLA._fused_call`` passes."""
    from cdfo_tpu_torch.models import attention as tattn
    from cdfo_tpu_torch.ops import cuda_build as cb
    seen = []

    def checked(fn, plain):
        def wrapped(*args):
            cb.check_operands(fn, *(a for a in args if a.dim() > 1))
            for a in args:
                assert a.is_contiguous(), fn
            seen.append(fn)
            return plain(*args)
        return wrapped

    monkeypatch.setattr(tattn, "eg1_rows",
                        checked("eg1", fe.eg1_rows_plain))
    monkeypatch.setattr(tattn, "eg2_local_fuse",
                        checked("eg2", fe.eg2_local_fuse_plain))
    params, res, x = _egla_params(True)
    tmod = EGLA(C, fused=True, dtype=dtype)
    tmod.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        tmod(t_(res).to(dtype), t_(x).to(dtype))
    assert seen == ["eg1", "eg2"]


# -- the model and the engine --------------------------------------------------------

NF, T, HE, WE = 32, 6, 16, 24
FOUR = dict(fused_trunk=True, fused_embed=True, fused_align=True,
            fused_egla=True)


@pytest.fixture(scope="module")
def setup():
    """JAX weights of the unfused model (the mask excited) in a JAX model
    and a port model with all four fused flags."""
    d = np.zeros((1, 7, HE, WE, 1), np.float32)
    dm = np.zeros((1, 7, HE, WE, 2), np.float32)
    base = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, mask_mode="expected"))
    params = jax.jit(base.init)(jax.random.PRNGKey(0), d, dm, dm, d, d, d)
    params = jax.tree.map(np.array, params)
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=1, mask_mode="expected",
                                  **FOUR))
    tmodel = CVSRV8(ModelConfig(nf=NF, scn_groups=1, **FOUR),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tmodel.load_state_dict(from_flax(params), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("k", [1, 4])
def test_four_flag_engine_matches_jax_engine(setup, k):
    jmodel, params, tmodel = setup
    ref, _ = JEngine(jmodel, params, k=k).run_sequence(
        j_synthetic(t=T, h=HE, w=WE, seed=3))
    frames, _ = BatchedStreamingEngine(tmodel, k=k).run_sequence(
        synthetic_sequence(t=T, h=HE, w=WE, seed=3))
    assert frames.shape == ref.shape == (T, 4 * HE, 4 * WE)
    diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, (k, diff.max(), (diff > 1).sum())
    assert frames.std() > 0


def test_excite_egla_mask_sets_one_bit_per_frame():
    """Under seeded random weights no channel passes the threshold (the
    fault the helper repairs in chip_smoke.py); after it, exactly one per
    frame does, at the full width."""
    model = CVSRV8(ModelConfig(scn_groups=1),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    rms = t_(np.random.RandomState(4).rand(3, 16, 24, 1))
    with torch.no_grad():
        before = model.RDAB.residual_mask(model.conv_expand_rms(rms))
        kc.excite_egla_mask(model)
        after = model.RDAB.residual_mask(model.conv_expand_rms(rms))
    assert before.sum().item() == 0
    assert after.sum(dim=1).tolist() == [1.0, 1.0, 1.0]
    assert after[:, 3].tolist() == [1.0, 1.0, 1.0]


def test_config_takes_four_flags_and_refuses_the_rest():
    cfg = ModelConfig(compute_dtype=torch.bfloat16, **FOUR)
    assert cfg.fused_egla and cfg.fused_trunk
    assert ModelConfig(fused_egla=True).fused_egla
    for flag in ("trunk_int8", "block_warp"):
        assert getattr(ModelConfig(**{flag: True}, **FOUR), flag)
    # cdfo_tpu ignores the scan trunk under the fused trunk
    with pytest.raises(ValueError, match="scan trunk under the fused trunk"):
        ModelConfig(scan_trunk=True, **FOUR)
