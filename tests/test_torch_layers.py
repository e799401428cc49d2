"""cdfo_tpu_torch layers and sub-modules against their cdfo_tpu
counterparts, in float32.

Weights go JAX ``init`` -> ``from_flax`` -> ``load_state_dict(strict)``, so
every test also checks that the port's parameter names and shapes are the
reference ``state_dict``'s. Inputs come from numpy seeds. Outputs agree
within 1e-4 of the reference's largest magnitude (the JAX suite's rule).
JAX runs as its own CPU tests run it: the attention takes its XLA
reference path off the TPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.models import alignment as jalign
from cdfo_tpu.models import attention as jattn
from cdfo_tpu.models import layers as jlayers
from cdfo_tpu.models import norms as jnorms
from cdfo_tpu.models import prior_encoder as jprior
from cdfo_tpu.models import trunk as jtrunk
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.models import alignment as talign
from cdfo_tpu_torch.models import attention as tattn
from cdfo_tpu_torch.models import layers as tlayers
from cdfo_tpu_torch.models import norms as tnorms
from cdfo_tpu_torch.models import prior_encoder as tprior
from cdfo_tpu_torch.models import trunk as ttrunk


def assert_close(port, ref, rel=1e-4):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1.0), err


def arrays(seed, *shapes, scale=1.0):
    r = np.random.RandomState(seed)
    return [(r.randn(*s) * scale).astype(np.float32) for s in shapes]


def jax_params(jmod, *inputs):
    params = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    return jax.tree.map(np.array, params)


def jax_apply(jmod, params, *inputs, **kw):
    return jax.jit(lambda p, *a: jmod.apply(p, *a, **kw))(params, *inputs)


def load(tmod, params):
    tmod.load_state_dict(from_flax(params))
    return tmod.eval()


def run(tmod, *inputs, **kw):
    with torch.no_grad():
        return tmod(*map(torch.from_numpy, inputs), **kw)


def excite_egla(p, seed=0):
    """With default init the EGLA mask softmax is near uniform and no
    channel reaches 0.5, which would leave the long-range branch at zero.
    Push one channel's logit up and give the 9-tap convs a bias."""
    r = np.random.RandomState(seed)
    p["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    p["directW1_bias"] = np.float32(r.randn() * 0.1)
    p["directH1_bias"] = np.float32(r.randn() * 0.1)


# -- layers and norms ----------------------------------------------------------

@pytest.mark.parametrize("cin,cout,k,s,p,g", [
    (6, 8, 3, 2, 2, 1), (8, 8, 3, 1, 1, 8), (5, 7, 1, 1, 0, 1),
    (2, 1, 7, 1, 3, 1)])
def test_conv2d(cin, cout, k, s, p, g):
    (x,) = arrays(0, (2, 11, 13, cin))
    jmod = jlayers.Conv2d(cout, k, s, p, groups=g)
    params = jax_params(jmod, x)
    tmod = load(tlayers.Conv2d(cin, cout, k, s, p, groups=g), params)
    assert_close(run(tmod, x), jax_apply(jmod, params, x))


@pytest.mark.parametrize("op", [0, 1])
def test_conv_transpose2d(op):
    (x,) = arrays(1, (2, 6, 9, 5))
    jmod = jlayers.ConvTranspose2d(7, 3, 2, 2, op)
    params = jax_params(jmod, x)
    tmod = load(tlayers.ConvTranspose2d(5, 7, 3, 2, 2, op), params)
    assert_close(run(tmod, x), jax_apply(jmod, params, x))


@pytest.mark.parametrize("name", ["resblock", "calayer", "spatial", "norm"])
def test_small_layers(name):
    (x,) = arrays(2, (2, 8, 10, 16))
    jmod, tmod = {
        "resblock": (jlayers.ResidualBlockNoBN(16),
                     tlayers.ResidualBlockNoBN(16)),
        "calayer": (jlayers.CALayer(16), tlayers.CALayer(16)),
        "spatial": (jlayers.SpatialAttention(), tlayers.SpatialAttention()),
        "norm": (jnorms.ChannelLayerNorm(16), tnorms.ChannelLayerNorm(16)),
    }[name]
    params = jax_params(jmod, x)
    if name == "norm":
        w, b = arrays(3, (16,), (16,))
        params["params"]["weight"], params["params"]["bias"] = w, b
    load(tmod, params)
    assert_close(run(tmod, x), jax_apply(jmod, params, x))


def test_init_is_seeded_and_scaled():
    """Same generator seed -> same weights; residual-block convs use the
    0.1-scaled kaiming normal (std 0.1 * sqrt(2 / fan_in))."""
    a = tlayers.init_weights(tlayers.ResidualBlockNoBN(64),
                             torch.Generator().manual_seed(5))
    b = tlayers.init_weights(tlayers.ResidualBlockNoBN(64),
                             torch.Generator().manual_seed(5))
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    std = a.conv1.weight.std().item()
    assert abs(std - 0.1 * np.sqrt(2 / 576)) < 0.1 * std


# -- attention, prior encoder, alignment, trunk -------------------------------

def test_mdta():
    (x,) = arrays(4, (2, 8, 12, 16))
    jmod = jattn.MDTA(16, 8)
    params = jax_params(jmod, x)
    params["params"]["temperature"] = arrays(5, (8, 1, 1))[0] + 1.5
    tmod = load(tattn.MDTA(16, 8), params)
    assert_close(run(tmod, x), jax_apply(jmod, params, x))


@pytest.mark.parametrize("excite", [False, True])
def test_egla_expected_mask(excite):
    res, x = arrays(6, (2, 16, 24, 16), (2, 16, 24, 16))
    jmod = jattn.EGLA(16, mask_mode="expected")
    params = jax_params(jmod, res, x)
    if excite:
        excite_egla(params["params"])
    tmod = load(tattn.EGLA(16), params)
    assert_close(run(tmod, res, x), jax_apply(jmod, params, res, x))


def test_egla_long_range_runs_in_float32_under_bf16(monkeypatch):
    """EGLA's 9-tap convs add a float32 bias, which promotes the row and
    column attention inputs to float32 in a bfloat16 model — in JAX, and
    so in the port, where the kernel's main-path dtype follows from it."""
    seen = {}

    def record(name, fn):
        def wrapped(q, v, *args, **kw):
            if kw.get("use_pallas", True):  # JAX's window attention: False
                seen.setdefault(name, set()).add(str(q.dtype).split(".")[-1])
            return fn(q, v, *args, **kw)
        return wrapped

    for mod, tag in ((jattn, "jax"), (tattn, "torch")):
        monkeypatch.setattr(mod, "token_self_attention",
                            record(f"{tag} row", mod.token_self_attention))
        monkeypatch.setattr(mod, "column_self_attention",
                            record(f"{tag} column",
                                   mod.column_self_attention))
    res, x = (jnp.asarray(a, jnp.bfloat16)
              for a in arrays(12, (1, 8, 16, 64), (1, 8, 16, 64)))
    jmod = jattn.EGLA(64, mask_mode="expected", dtype=jnp.bfloat16)
    jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), res, x))
    tmod = tlayers.init_weights(tattn.EGLA(64, dtype=torch.bfloat16),
                                torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tmod(*(torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                     for a in (res, x)))
    assert out.dtype == torch.bfloat16
    assert seen == {k: {"float32"} for k in (
        "jax row", "jax column", "torch row", "torch column")}


def test_partition_transformer():
    x1, x2 = arrays(7, (2, 16, 24, 16), (2, 16, 24, 16))
    jmod = jprior.PartitionTransformerSA2(16, 8)
    params = jax_params(jmod, x1, x2)
    tmod = load(tprior.PartitionTransformerSA2(16, 8), params)
    assert_close(run(tmod, x1, x2), jax_apply(jmod, params, x1, x2))


@pytest.mark.parametrize("prewarped", [False, True])
def test_dual_att_alignment(prewarped):
    x, extra, pred = arrays(8, *[(3, 8, 12, 16)] * 3)
    (flow,) = arrays(9, (3, 8, 12, 2), scale=3.0)
    jmod = jalign.DualAttAlignment(16, 4)
    params = jax_params(jmod, x, extra, pred, flow)
    params["params"]["msa"]["temperature"] += 0.5
    tmod = load(talign.DualAttAlignment(16, 4), params)
    if prewarped:
        warped = arrays(10, (3, 8, 12, 16))[0]
        ref = jax.jit(lambda p, *a: jmod.apply(p, a[0], None, *a[1:]))(
            params, x, pred, flow, warped)
        out = run(tmod, x, extra, pred, flow,
                  warped_feat=torch.from_numpy(warped))
    else:
        ref = jax_apply(jmod, params, x, extra, pred, flow)
        out = run(tmod, x, extra, pred, flow)
    assert_close(out, ref)


def test_scnet_trunk():
    (x,) = arrays(11, (2, 8, 12, 16))
    jmod = jtrunk.SCNetS(16, 2)
    params = jax_params(jmod, x)
    tmod = load(ttrunk.SCNetS(16, 2), params)
    assert_close(run(tmod, x), jax_apply(jmod, params, x))
