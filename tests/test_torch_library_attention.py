"""The port's attention library and Swin stack that no registry model
builds, against ``cdfo_tpu``'s in float32 on the CPU: the residual-guided
blocks ``RDABS`` and ``RSNLAttention`` (expected mask, and the sampled one
on an injected uniform draw), ``RDABUnderscore``, ``PAM`` / ``RPAB``,
``CAMSelf`` / ``CAM``, ``RCAB``, ``NonLocalAttention``,
``CrissCrossAttention``, ``SKFF``, ``ContextBlock``, the 3-D blocks
``CalibResBlock3D`` / ``ResBlock3D``; and ``models/swin.py``: window
partition and reverse, the relative position index, the shift mask,
``WindowAttention``, ``Mlp``, ``SwinTransformerBlock`` (shift 0 and 4),
``BasicLayer``, ``RSTB`` and the patch embed / unembed. nf 16 at 16x24
(swin: windows of 8), every zero-initialised weight refilled
(``torch_library_common``), tolerance 1e-4 of the reference's largest
value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.models import attention_variants as jav
from cdfo_tpu.models import swin as jswin
from cdfo_tpu_torch.models import attention_variants as tav
from cdfo_tpu_torch.models import swin as tswin
from cdfo_tpu_torch.models.layers import init_weights
from torch_library_common import (assert_close, jax_params, load, rand, run,
                                  t_, uniform_draw)

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


def check(jm, port, *args, what=""):
    params = jax_params(jm, *args)
    assert_close(run(load(port, params), *args), jm.apply(params, *args),
                 what=what)
    return params


def _injected_uniform(u):
    """``jax.random.uniform`` that returns ``u`` for its shape (the gumbel
    draw of ``_sample_mask``)."""
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == u.shape:
            return jnp.asarray(u)
        return real_uniform(key, shape, *args, **kwargs)
    return uniform


@pytest.mark.parametrize("mode", ["expected", "sample"])
@pytest.mark.parametrize("block", ["rdabs", "rsnl"])
def test_gumbel_mask_blocks_match_cdfo_tpu(block, mode):
    """The sampled mask on an injected uniform draw: JAX's
    ``jax.random.uniform`` patched to return it, the port given it as
    ``u``."""
    res, x = rand(2, H, W, NF), rand(2, H, W, NF, seed=1)
    u = uniform_draw((2, H, W, NF))
    jcls, tcls = ((jav.RDABS, tav.RDABS) if block == "rdabs"
                  else (jav.RSNLAttention, tav.RSNLAttention))
    kw = {"reduction": 4} if block == "rdabs" else {}
    params = jax_params(jcls(NF, mask_mode="expected", **kw), res, x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _injected_uniform(u))
        ref = jcls(NF, mask_mode=mode, **kw).apply(
            params, res, x, rngs={"gumbel": jax.random.PRNGKey(3)})
    port = load(tcls(NF, mask_mode=mode, **kw), params)
    out = run(port, res, x, u=torch.from_numpy(u) if mode == "sample"
              else None)
    assert_close(out, ref, what=f"{block} {mode}")


def test_sampled_mask_draws_from_a_generator_and_checks_u():
    port = init_weights(tav.RDABS(NF, reduction=4, mask_mode="sample"),
                        torch.Generator().manual_seed(0)).eval()
    res, x = t_(rand(1, 8, 8, NF), rand(1, 8, 8, NF, seed=1))
    with torch.no_grad():
        a = port(res, x, torch.Generator().manual_seed(0))
        b = port(res, x, torch.Generator().manual_seed(0))
        c = port(res, x, torch.Generator().manual_seed(1))
        with pytest.raises(ValueError, match="torch.Generator"):
            port(res, x)
        with pytest.raises(ValueError, match="gumbel u"):
            port(res, x, u=torch.rand(1, 8, 8, NF + 1))
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["rdab_", "pam", "rpab", "cam_self", "cam",
                                  "rcab", "skff", "context"])
def test_attention_blocks_match_cdfo_tpu(name):
    a, b, c = (rand(2, H, W, NF, seed=s) for s in range(3))
    j, t, args = {
        "rdab_": (jav.RDABUnderscore(NF, 4), tav.RDABUnderscore(NF, 4),
                  (a, b, c)),
        "pam": (jav.PAM(NF), tav.PAM(NF), (a, b)),
        "rpab": (jav.RPAB(NF), tav.RPAB(NF), (a, b, c)),
        "cam_self": (jav.CAMSelf(), tav.CAMSelf(), (a * 0.2,)),
        "cam": (jav.CAM(), tav.CAM(), (a * 0.2, b, c * 0.2)),
        "rcab": (jav.RCAB(NF), tav.RCAB(NF), (a,)),
        "skff": (jav.SKFF(NF), tav.SKFF(NF), (a, b)),
        "context": (jav.ContextBlock(NF), tav.ContextBlock(NF), (a,)),
    }[name]
    params = check(j, t, *args, what=name)
    if name in ("pam", "cam_self", "cam"):
        assert np.asarray(jax.tree.leaves(params)[0]).any()   # gamma


def test_non_local_attention_matches_cdfo_tpu():
    check(jav.NonLocalAttention(NF), tav.NonLocalAttention(NF),
          rand(2, H, W, NF))


def test_criss_cross_attention_matches_cdfo_tpu():
    """The residual zero at a third of the pixels, so the key mask
    holds both values; the -inf diagonal of the column branch."""
    res = rand(2, H, W, NF)
    res[:, ::3] = 0.0
    check(jav.CrissCrossAttention(NF), tav.CrissCrossAttention(NF), res,
          rand(2, H, W, NF, seed=1))


@pytest.mark.parametrize("block", ["calib", "res"])
def test_3d_residual_blocks_match_cdfo_tpu(block):
    jm, port = ((jav.CalibResBlock3D(8), tav.CalibResBlock3D(8))
                if block == "calib" else
                (jav.ResBlock3D(8), tav.ResBlock3D(8)))
    check(jm, port, rand(2, H, W, NF), what=block)


# -- swin --------------------------------------------------------------------

SD = 32   # swin dim: 4 heads of 8


def test_window_partition_and_index_match_cdfo_tpu():
    x = rand(2, H, W, 8)
    wins = tswin.window_partition(*t_(x), 8)
    assert_close(wins, jswin.window_partition(jnp.asarray(x), 8))
    assert torch.equal(tswin.window_reverse(wins, 8, H, W), *t_(x))
    np.testing.assert_array_equal(tswin._relative_position_index((8, 8)),
                                  jswin._relative_position_index((8, 8)))
    np.testing.assert_array_equal(
        tswin._shift_attn_mask(H, W, 8, 4).numpy(),
        np.asarray(jswin._shift_attn_mask(H, W, 8, 4)))


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_matches_cdfo_tpu(shift):
    x = rand(2, H * W, SD)
    jm = jswin.SwinTransformerBlock(SD, 4, 8, shift)
    params = jax_params(jm, x, (H, W), jit=False)
    port = load(tswin.SwinTransformerBlock(SD, 4, 8, shift), params)
    with torch.no_grad():
        out = port(*t_(x), (H, W))
    assert_close(out, jm.apply(params, x, (H, W)), what=str(shift))


def test_window_attention_with_mask_and_mlp_match_cdfo_tpu():
    x = rand(6, 64, SD)
    mask = np.asarray(jswin._shift_attn_mask(H, W, 8, 4))
    jm = jswin.WindowAttention(SD, (8, 8), 4)
    params = jax_params(jm, x, jnp.asarray(mask))
    port = load(tswin.WindowAttention(SD, (8, 8), 4), params)
    assert_close(run(port, x, mask), jm.apply(params, x, jnp.asarray(mask)))
    jmlp = jswin.Mlp(48, SD)
    check(jmlp, tswin.Mlp(SD, 48, SD), x)


def test_rstb_and_patch_embed_match_cdfo_tpu():
    """``RSTB`` of depth 2 (a plain and a shifted block) on the tokens of
    a normed ``PatchEmbed``, back to an image by ``PatchUnEmbed``."""
    img = rand(2, H, W, SD)
    jemb = jswin.PatchEmbed(use_norm=True)
    pe = jax_params(jemb, img)
    tokens = jemb.apply(pe, img)
    assert_close(run(load(tswin.PatchEmbed(SD, use_norm=True), pe), img),
                 tokens)
    jm = jswin.RSTB(SD, depth=2, num_heads=4, window_size=8)
    params = jax_params(jm, tokens, (H, W), jit=False)
    port = load(tswin.RSTB(SD, depth=2, num_heads=4, window_size=8), params)
    with torch.no_grad():
        out = port(torch.from_numpy(np.asarray(tokens)), (H, W))
    ref = jm.apply(params, tokens, (H, W))
    assert_close(out, ref)
    assert_close(tswin.PatchUnEmbed()(out, (H, W)),
                 jswin.PatchUnEmbed().apply({}, ref, (H, W)))
