"""The port's model zoo against cdfo_tpu's, in float32 on the CPU.

Module by module, on JAX-initialised weights (nf 16, 16x24 frames) in
which every zero-initialised weight (the deformable offset and mask heads)
is refilled with seeded non-zero values, so a wrong offset layout cannot
pass: the plain ``deform_conv2d`` (the reference's golden values, random
out-of-image offsets, 16 deformable groups, weight groups, stride and
dilation) and the v1 / v2 packs, EGLA's woLA / woGA variants and CVSR_V9's
EGLA1, CVSR_V7's RDAB (expected mask, and the sampled one on an injected
uniform draw), the two
DCN-family alignments (``MVDualAttAlignment``, ``MVLocalAttn``),
``FeaFusion``, the SFT stack, the pyramid trunk and both scan trunks; then
CVSR_V7, CVSR_V9 and SIDECVSR whole, with and without ``pre_l1``, V7 and V9
through the per-window inferencer (uint8 within 1 LSB), two train steps of
the scan trunk against cdfo_tpu's, the scan-layout adapters, a reference
``state_dict`` into V7, and every registry name. Tolerance: 1e-4 of the
reference's largest value.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.compat import scan_params as jscan
from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.config import TrainConfig as JTrainConfig
from cdfo_tpu.infer.pipeline import StreamingInferencer as JInferencer
from cdfo_tpu.infer.pipeline import synthetic_sequence as j_synthetic
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.models import MODEL_REGISTRY as J_REGISTRY
from cdfo_tpu.models import alignment_dcn as jad
from cdfo_tpu.models import attention_variants as jav
from cdfo_tpu.models import cvsr_variants as jcv
from cdfo_tpu.models import dcn as jdcn
from cdfo_tpu.models import sft as jsft
from cdfo_tpu.models import trunk as jtrunk
from cdfo_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from cdfo_tpu.train.state import create_train_state, train_step as j_step
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import (from_flax, load_reference_state_dict,
                                   scan_params as tscan)
from cdfo_tpu_torch.config import TrainConfig
from cdfo_tpu_torch.infer import (BatchedStreamingEngine, StreamingInferencer,
                                  synthetic_sequence)
from cdfo_tpu_torch.models import MODEL_REGISTRY, CVSRV8, build_model
from cdfo_tpu_torch.models import alignment_dcn as tad
from cdfo_tpu_torch.models import attention_variants as tav
from cdfo_tpu_torch.models import dcn as tdcn
from cdfo_tpu_torch.models import sft as tsft
from cdfo_tpu_torch.models import trunk as ttrunk
from cdfo_tpu_torch.models.layers import init_weights
from cdfo_tpu_torch.ops.deform_conv import deform_conv2d
from cdfo_tpu_torch.train import state as tstate

NF, H, W = 16, 16, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def assert_close(port, ref, rel=1e-4, what=""):
    port = (port.detach().float().numpy() if isinstance(port, torch.Tensor)
            else np.asarray(port, np.float32))
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def refill_zeros(tree, seed=1):
    """Every all-zero weight (not a scalar) refilled with seeded values of
    std 0.05: the zero-initialised offset and mask heads, and biases."""
    r = np.random.RandomState(seed)

    def fill(x):
        x = np.array(x)
        if x.size > 1 and not x.any():
            x = (r.randn(*x.shape) * 0.05).astype(x.dtype)
        return x
    return jax.tree.map(fill, tree)


def jax_init(module, *args):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *args)
    return refill_zeros(jax.tree.map(np.array, params))


def load(port, params, scope="deform_align"):
    """``from_flax`` of a module's tree, under a scope name so that a raw
    DCN weight at the module's top is read as one."""
    sd = from_flax({scope: params["params"]})
    port.load_state_dict({k[len(scope) + 1:]: v for k, v in sd.items()})
    return port


def t_(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# -- the deformable convolution --------------------------------------------------

def test_deform_conv_golden_values():
    """The reference's only DCN unit test (`ops/dcn/simple_check.py`): offsets
    that retarget every tap at the window centre."""
    x = np.arange(18, dtype=np.float32).reshape(1, 2, 3, 3).transpose(
        0, 2, 3, 1)
    off = np.tile(np.array([1, 1, 1, 0, 1, -1, 0, 1, 0, 0, 0, -1, -1, 1, -1,
                            0, -1, -1], np.float32), 2)
    offset = np.broadcast_to(off, (1, 3, 3, 36))
    out = deform_conv2d(*t_(x, offset), torch.ones(1, 2, 3, 3), padding=1)
    np.testing.assert_allclose(
        out.numpy().ravel(), [81, 99, 117, 135, 153, 171, 189, 207, 225],
        atol=1e-5)


@pytest.mark.parametrize("groups,dg,stride,padding,dilation,masked", [
    (1, 16, 1, 1, 1, True), (2, 4, 2, 2, 1, True), (1, 2, 1, 2, 2, False)])
def test_deform_conv_matches_jax(groups, dg, stride, padding, dilation,
                                 masked):
    b, h, w, cin, cout, k = 2, 9, 11, 32, 8, 3
    ho = (h + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    wo = (w + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    x = rand(b, h, w, cin)
    # offsets up to 8 pixels: many taps fall partly or wholly outside
    offset = rand(b, ho, wo, 2 * dg * k * k, seed=1, scale=4.0)
    wj = rand(k, k, cin // groups, cout, seed=2, scale=0.1)
    bias = rand(cout, seed=3)
    mask = (np.random.RandomState(4).rand(b, ho, wo, dg * k * k)
            .astype(np.float32) if masked else None)
    ref = j_deform_conv2d(jnp.asarray(x), jnp.asarray(offset),
                          jnp.asarray(wj), jnp.asarray(bias),
                          None if mask is None else jnp.asarray(mask),
                          stride, padding, dilation, groups)
    out = deform_conv2d(*t_(x, offset, wj.transpose(3, 2, 0, 1), bias),
                        None if mask is None else torch.from_numpy(mask),
                        stride, padding, dilation, groups)
    assert_close(out, ref)


@pytest.mark.parametrize("groups,dg", [(1, 8), (2, 4)])
def test_deform_conv_bf16_rounds_once(groups, dg):
    """At bf16 the products are summed in float32 and rounded once, as
    ``cdfo_tpu``'s one einsum over (K, Cin) does: every output within one
    bf16 ulp of ``cdfo_tpu``'s at bf16 (a sum rounded per tap is off by
    several)."""
    b, h, w, cin, cout = 2, 9, 11, 64, 16
    x = rand(b, h, w, cin)
    offset = rand(b, h, w, 2 * dg * 9, seed=1, scale=4.0)
    wj = rand(3, 3, cin // groups, cout, seed=2, scale=0.1)
    bias = rand(cout, seed=3)
    mask = np.random.RandomState(4).rand(b, h, w, dg * 9).astype(np.float32)
    bf = functools.partial(jnp.asarray, dtype=jnp.bfloat16)
    ref = np.asarray(j_deform_conv2d(bf(x), jnp.asarray(offset), bf(wj),
                                     bf(bias), bf(mask), 1, 1, 1, groups),
                     np.float32)
    x_, w_, b_, m_ = (t.bfloat16() for t in t_(x, wj.transpose(3, 2, 0, 1),
                                               bias, mask))
    out = deform_conv2d(x_, torch.from_numpy(offset), w_, b_, m_, 1, 1, 1,
                        groups)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert (err <= 2.0 ** -7 * np.abs(ref)).all(), err.max()


@pytest.mark.parametrize("name,stride", [("DeformConvPack", 1),
                                         ("ModulatedDeformConvPack", 2)])
def test_dcn_packs_match_jax(name, stride):
    """The v1 and v2 packs (weight groups 2, 4 deformable groups), their
    zero-initialised offset heads refilled."""
    x = rand(2, 9, 11, 16)
    jm = getattr(jdcn, name)(8, 3, stride, 1, 1, 2, 4)
    params = jax_init(jm, x)
    port = load(getattr(tdcn, name)(16, 8, 3, stride, 1, 1, 2, 4), params)
    with torch.no_grad():
        out = port(*t_(x))
    assert_close(out, jm.apply(params, x), what=name)


# -- EGLA's variants and RDAB -----------------------------------------------------

@pytest.mark.parametrize("name", ["EGLAwoLA", "EGLAwoGA", "EGLA1"])
def test_egla_variants_match_jax(name):
    res, x = rand(3, H, W, NF), rand(3, H, W, NF, seed=1)
    jm = getattr(jav, name)(NF)
    args = (x,) if name == "EGLAwoLA" else (res, x)
    params = jax_init(jm, *args)
    port = load(getattr(tav, name)(NF), params)
    with torch.no_grad():
        out = port(*t_(*args))
    if name == "EGLA1":   # the full-resolution mask is neither 0 nor 1
        with torch.no_grad():
            rm = torch.sigmoid(port.conv_du_re(torch.from_numpy(res)))
        assert 0.1 < (rm >= 0.5).float().mean() < 0.9
    assert_close(out, jm.apply(params, *args), what=name)


@pytest.mark.parametrize("mode", ["expected", "sample"])
def test_rdab_matches_jax(mode):
    res, x = rand(3, H, W, NF), rand(3, H, W, NF, seed=1)
    u = np.maximum(np.random.RandomState(5).rand(3, H, W, NF),
                   np.finfo(np.float32).tiny).astype(np.float32)
    jm = jav.RDAB(NF, mask_mode=mode)
    params = jax_init(jm, res, x) if mode == "expected" else \
        jax_init(jav.RDAB(NF, mask_mode="expected"), res, x)
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == u.shape:
            return jnp.asarray(u)
        return real_uniform(key, shape, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        ref = jm.apply(params, res, x, rngs={"gumbel": jax.random.PRNGKey(3)})
    port = load(tav.RDAB(NF, mask_mode=mode), params)
    with torch.no_grad():
        out = port(*t_(res, x), u=torch.from_numpy(u)
                   if mode == "sample" else None)
    assert_close(out, ref, what=mode)


# -- the DCN-family alignments, FeaFusion, the SFT stack --------------------------

def test_mv_dual_att_alignment_matches_jax():
    x, extra, pred = (rand(2, H, W, NF, seed=s) for s in range(3))
    flow = rand(2, H, W, 2, seed=3, scale=3.0)
    jm = jad.MVDualAttAlignment(NF, 3, 1, 16, 10.0)
    params = jax_init(jm, x, extra, pred, flow)
    head = params["params"]["conv_offset_2"]["conv"]["kernel"]
    assert head.any()   # refilled: the offsets are more than the flow
    port = load(tad.MVDualAttAlignment(NF, 3, 1, 16, 10.0), params)
    with torch.no_grad():
        out = port(*t_(x, extra, pred, flow))
    assert_close(out, jm.apply(params, x, extra, pred, flow))


def test_mv_local_attn_and_fea_fusion_match_jax():
    nbh, cen = rand(2, H, W, NF), rand(2, H, W, NF, seed=1)
    mv = rand(2, H, W, 2, seed=2, scale=3.0)
    jm = jad.MVLocalAttn(NF, 3)
    params = jax_init(jm, nbh, cen, mv)
    port = load(tad.MVLocalAttn(NF, 3), params)
    with torch.no_grad():
        out = port(*t_(nbh, cen, mv))
    assert_close(out, jm.apply(params, nbh, cen, mv), what="MVLocalAttn")
    feas = rand(2, H, W, 7 * NF, seed=3)
    jm = jad.FeaFusion(NF, 7)
    params = jax_init(jm, feas)
    port = load(tad.FeaFusion(NF, 7), params)
    with torch.no_grad():
        out = port(*t_(feas))
    assert_close(out, jm.apply(params, feas), what="FeaFusion")


def test_sft_stack_matches_jax():
    feas, side = rand(2, H, W, NF), rand(2, H, W, NF // 2, seed=1)
    jm = jsft.SideEmbeddedFeatureExtractBlock(NF)
    params = jax_init(jm, feas, side)
    port = load(tsft.SideEmbeddedFeatureExtractBlock(NF), params)
    with torch.no_grad():
        out = port(*t_(feas, side))
    assert_close(out, jm.apply(params, feas, side))


# -- the trunks -------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True])
def test_pyramid_trunk_matches_jax(scan):
    xs = [rand(1, H // s, W // s, NF, seed=s) for s in (1, 2, 4)]
    jm = (jtrunk.SCNetPyrScan if scan else jtrunk.SCNetPyr)(NF, 2)
    params = jax_init(jm, xs)
    # the scan tree is stacked: groups/g with a leading group axis
    assert ("groups" in params["params"]) == scan
    port = (ttrunk.SCNetPyrScan if scan else ttrunk.SCNetPyr)(NF, 2)
    sd = from_flax({"recon_trunk": params["params"]})
    port.load_state_dict({k[len("recon_trunk."):]: v for k, v in sd.items()})
    with torch.no_grad():
        outs = port(list(t_(*xs)))
    for o, r in zip(outs, jm.apply(params, xs)):
        assert_close(o, r)


def test_scan_param_adapters_equal_cdfo_tpu():
    """``to_scan_trunk`` / ``from_scan_trunk`` equal cdfo_tpu's on an unrolled
    CVSR_V8 tree, and ``from_flax`` of the stacked tree gives the unrolled
    tree's ``state_dict``."""
    _, params = jax_v8(scan=False)
    stacked = tscan.to_scan_trunk(params)
    ref = jscan.to_scan_trunk(params)
    assert jax.tree.structure(jax.tree.map(np.asarray, ref)) == \
        jax.tree.structure(stacked)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = tscan.from_scan_trunk(stacked)
    for a, b in zip(jax.tree.leaves(jscan.from_scan_trunk(ref)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    flat, from_stacked = from_flax(params), from_flax(stacked)
    assert set(flat) == set(from_stacked)
    for k in flat:
        assert torch.equal(flat[k], from_stacked[k]), k


def model_inputs(seed=0, b=1):
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(b, 7, H, W, 1).astype(np.float32)
                          for _ in range(4))
    mvs0 = (r.randn(b, 7, H, W, 2) * 2).astype(np.float32)
    mvs1 = (r.randn(b, 7, H, W, 2) * 2).astype(np.float32)
    return lrs, mvs0, mvs1, pms, rms, ufs


@functools.lru_cache(maxsize=None)
def jax_v8(scan):
    jm = JCVSRV8(JModelConfig(nf=NF, scn_groups=2, mask_mode="expected",
                              scan_trunk=scan))
    params = jax.tree.map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(0), *model_inputs()))
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    return jm, params


def test_scan_trunk_v8_matches_jax():
    jm, params = jax_v8(scan=True)
    port = CVSRV8(ModelConfig(nf=NF, scn_groups=2, scan_trunk=True),
                  generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(port.recon_trunk, ttrunk.SCNetSScan)
    port.load_state_dict(from_flax(params))
    args = model_inputs(1)
    with torch.no_grad():
        out, _ = port(*t_(*args))
    assert_close(out, jax.jit(jm.apply)(params, *args)[0])


def train_batch(seed):
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(1, 7, H, W, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(1, 7, H, W, 2) * 1.5).astype(np.float32)
    return {"lrs": lrs, "mvs0": mvs, "mvs1": mvs, "pms": pms, "rms": rms,
            "ufs": ufs, "hr": r.rand(1, 4 * H, 4 * W, 1).astype(np.float32)}


def test_scan_trunk_train_steps_match_cdfo_tpu():
    """Two train steps of the scan trunk, the EGLA mask's gumbel draw
    injected into both (``jax.random.uniform`` patched by its shape): the
    losses within 1e-4 relative and every parameter after the second step
    within 1e-4 relative L2 of cdfo_tpu's; and the port's scan run equal,
    bit for bit, to its unrolled run (the recomputed groups give the same
    gradients). Where a parameter's first gradient is at float32's rounding
    (below 1e-6 of the model's largest; EGLA's 9-tap biases, which reach
    the loss only through cancelling sums), Adam still moves it by lr, in a
    size and sign that rounding sets (see test_torch_train), and it is held
    within 1e-3."""
    u = np.maximum(np.random.RandomState(7).rand(6, H, W, NF),
                   np.finfo(np.float32).tiny).astype(np.float32)
    model = JCVSRV8(JModelConfig(nf=NF, scn_groups=2, scan_trunk=True,
                                 mask_mode="sample"))
    b0, b1 = train_batch(1), train_batch(2)
    state = create_train_state(model, JTrainConfig(), b0)
    init = from_flax(jax.tree.map(np.asarray, state.params))
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == u.shape:
            return jnp.asarray(u)
        return real_uniform(key, shape, *args, **kwargs)

    step = jax.jit(j_step)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        state1, loss1 = step(state, b0, jax.random.PRNGKey(0))
        state2, loss2 = step(state1, b1, jax.random.PRNGKey(1))
    final = from_flax(jax.tree.map(np.asarray, state2.params))
    runs = {}
    for scan in (True, False):
        port = CVSRV8(ModelConfig(nf=NF, scn_groups=2, scan_trunk=scan,
                                  mask_mode="sample"),
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
        port.load_state_dict(init)
        ts = tstate.TrainState(port, TrainConfig())
        first = {}
        apply = ts.apply_gradients

        def recording_apply():
            if not first:
                first.update({n: p.grad.abs().max().item()
                              for n, p in port.named_parameters()
                              if p.grad is not None})
            apply()

        ts.apply_gradients = recording_apply
        losses = [float(tstate.train_step(ts, b, gumbel_u=torch.from_numpy(u)))
                  for b in (b0, b1)]
        runs[scan] = losses, port.state_dict(), first
    losses, sd, first = runs[True]
    for loss, ref in zip(losses, (loss1, loss2)):
        assert abs(loss - float(ref)) <= 1e-4 * abs(float(ref))
    gmax = max(first.values())
    for name, p in final.items():
        err = ((sd[name] - p).norm() / p.norm()).item()
        rounding = first.get(name, 0.0) < 1e-6 * gmax
        assert err <= (1e-3 if rounding else 1e-4), (name, err)
    assert losses == runs[False][0]
    for name, p in runs[False][1].items():
        assert torch.equal(sd[name], p), name


# -- CVSR_V7, CVSR_V9 and SIDECVSR ------------------------------------------------

VARIANTS = {"cvsr_v7": jcv.CVSRV7, "cvsr_v9": jcv.CVSRV9,
            "sidecvsr": jcv.SIDECVSRModel}


def variant_args(name, seed=0):
    lrs, mvs0, mvs1, pms, rms, ufs = model_inputs(seed)
    if name == "sidecvsr":
        return lrs, mvs1, pms, rms, ufs
    return lrs, mvs0, mvs1, pms, rms, ufs


@functools.lru_cache(maxsize=None)
def jax_variant(name):
    jm = VARIANTS[name](JModelConfig(name=name, nf=NF, scn_groups=1,
                                     mask_mode="expected"))
    return jm, jax_init(jm, *variant_args(name))


def port_variant(name, **kw):
    _, params = jax_variant(name)
    model = build_model(name, ModelConfig(name=name, nf=NF, scn_groups=1,
                                          **kw), device="cpu")
    model.load_state_dict(from_flax(params))
    return model


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_matches_jax(name):
    jm, params = jax_variant(name)
    model = port_variant(name)
    args = variant_args(name, 1)
    pre = rand(1, 7, H, W, NF, seed=2)
    for p in (None, pre):
        ref, l1 = jax.jit(jm.apply)(params, *args, pre_l1=p)
        with torch.no_grad():
            out, t_l1 = model(*t_(*args), pre_l1=None if p is None
                              else torch.from_numpy(p))
        assert_close(out, ref, what=(name, p is None))
        assert_close(t_l1, l1, what=(name, "l1"))


def test_v7_sampled_mask_matches_jax():
    """CVSR_V7's RDAB draws one gumbel sample per pyramid level; the three
    uniform draws, coarse to fine, injected into both."""
    _, params = jax_variant("cvsr_v7")
    jm = jcv.CVSRV7(JModelConfig(name="cvsr_v7", nf=NF, scn_groups=1,
                                 mask_mode="sample"))
    r = np.random.RandomState(9)
    draws = [np.maximum(r.rand(6, H // s, W // s, NF),
                        np.finfo(np.float32).tiny).astype(np.float32)
             for s in (4, 2, 1)]
    by_shape = {d.shape: d for d in draws}
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) in by_shape:
            return jnp.asarray(by_shape[tuple(shape)])
        return real_uniform(key, shape, *args, **kwargs)

    args = variant_args("cvsr_v7", 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        ref, _ = jm.apply(params, *args,
                          rngs={"gumbel": jax.random.PRNGKey(0)})
    model = port_variant("cvsr_v7", mask_mode="sample")
    with torch.no_grad():
        out, _ = model(*t_(*args), gumbel_u=[torch.from_numpy(d)
                                             for d in draws])
        other, _ = model(*t_(*args), gumbel_u=[torch.from_numpy(d[::-1].copy())
                                               for d in draws])
    assert_close(out, ref)
    # other draws move the frames past the tolerance
    assert np.abs(other.numpy() - np.asarray(ref)).max() > \
        1e-4 * np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize("name", ["cvsr_v7", "cvsr_v9"])
def test_variant_inferencer_matches_jax(name):
    jm, params = jax_variant(name)
    ref, _ = JInferencer(jm, params).run_sequence(
        j_synthetic(t=5, h=H, w=W, seed=3))
    frames, _ = StreamingInferencer(port_variant(name)).run_sequence(
        synthetic_sequence(t=5, h=H, w=W, seed=3))
    assert frames.shape == ref.shape == (5, 4 * H, 4 * W)
    diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and frames.std() > 0, diff.max()


def test_v9_takes_the_fused_trunk_and_embed():
    """V9 with ``fused_trunk`` and ``fused_embed`` (on the CPU their plain
    versions) gives the unfused V9's frames through the inferencer."""
    data = synthetic_sequence(t=3, h=H, w=W, seed=3)
    plain, _ = StreamingInferencer(port_variant("cvsr_v9")).run_sequence(data)
    fused, _ = StreamingInferencer(port_variant(
        "cvsr_v9", fused_trunk=True, fused_embed=True)).run_sequence(data)
    assert np.abs(fused.astype(np.int32) - plain.astype(np.int32)).max() <= 1


def test_reference_state_dict_loads_into_v7():
    """A ``state_dict`` under the reference's key names (with keys of its
    dead submodules) into CVSR_V7 by ``load_reference_state_dict``: the
    dead keys are dropped and the forward is cdfo_tpu's."""
    jm, params = jax_variant("cvsr_v7")
    sd = {k: v.numpy() for k, v in from_flax(params).items()}
    sd["MV_deform_align.conv_offset_mask.weight"] = np.zeros((432, NF, 3, 3))
    sd["transformer_feature_extraction.adaptiveWeight"] = np.ones(2)
    model = build_model("cvsr_v7", ModelConfig(name="cvsr_v7", nf=NF,
                                               scn_groups=1), device="cpu")
    dead = load_reference_state_dict(model, sd)
    assert dead == ["MV_deform_align.conv_offset_mask.weight",
                    "transformer_feature_extraction.adaptiveWeight"]
    args = variant_args("cvsr_v7", 1)
    with torch.no_grad():
        out, _ = model(*t_(*args))
    assert_close(out, jax.jit(jm.apply)(params, *args)[0])


# -- the registry -----------------------------------------------------------------

def test_every_registry_name_builds():
    """Every name of cdfo_tpu's registry builds in the port, at the depth
    cdfo_tpu's registry gives it; the engine takes the CVSR_V8 family
    only, the inferencer all but SIDECVSR."""
    assert set(MODEL_REGISTRY) == set(J_REGISTRY)
    for name in J_REGISTRY:
        model = MODEL_REGISTRY[name](device="cpu")
        assert model.cfg.name == name
        assert model.cfg.scn_groups == (4 if name == "sidecvsr" else 7)
        assert len(model.recon_trunk.body) == model.cfg.scn_groups
        small = build_model(name, ModelConfig(nf=NF, scn_groups=1),
                            generator=torch.Generator().manual_seed(1),
                            device="cpu")
        if small.cfg.v8_family:
            BatchedStreamingEngine(small, k=1)
        else:
            with pytest.raises(ValueError, match="StreamingInferencer"):
                BatchedStreamingEngine(small, k=1)
        if name == "sidecvsr":
            with pytest.raises(ValueError, match="SIDECVSR"):
                StreamingInferencer(small)
        else:
            StreamingInferencer(small)
    a, b = (init_weights(MODEL_REGISTRY["cvsr_v9"](device="cpu"),
                         torch.Generator().manual_seed(3)) for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
