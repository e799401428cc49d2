"""The cdfo_tpu_torch CVSR_V8 model against cdfo_tpu's, in float32.

Weights go JAX ``init`` -> ``from_flax`` -> ``load_state_dict(strict)``, so
every test also checks that the port's parameter names and shapes are the
reference ``state_dict``'s. Inputs come from numpy seeds. Outputs agree
within 1e-4 of the reference's largest magnitude (the JAX suite's rule).
JAX runs as its own CPU tests run it: the attention takes its XLA
reference path off the TPU.
"""
import jax
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.ops.warp import QUAD_PAD
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.models import CVSRV8


def assert_close(port, ref, rel=1e-4):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1.0), err


def arrays(seed, *shapes, scale=1.0):
    r = np.random.RandomState(seed)
    return [(r.randn(*s) * scale).astype(np.float32) for s in shapes]


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


# -- the whole model ----------------------------------------------------------

NF, H, W = 32, 16, 24


@pytest.fixture(scope="module")
def models():
    """One set of JAX weights (EGLA excited) in both packages."""
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=2, mask_mode="expected"))
    d = np.zeros((1, 7, H, W, 1), np.float32)
    dm = np.zeros((1, 7, H, W, 2), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), d, dm, dm, d, d, d)
    params = jax.tree.map(np.array, params)
    excite_egla(params["params"]["RDAB"])
    tmodel = CVSRV8(ModelConfig(nf=NF, scn_groups=2),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    load(tmodel, params)
    return jmodel, params, tmodel


def _window(seed):
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(1, 7, H, W, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(1, 7, H, W, 2) * 2).astype(np.float32)
    return lrs, mvs, mvs, pms, rms, ufs


@pytest.mark.parametrize("recurrent", [False, True])
def test_cvsr_v8_forward(models, recurrent):
    jmodel, params, tmodel = models
    inputs = _window(12)
    kw = {}
    if recurrent:
        pre = arrays(13, (1, 7, H, W, NF))[0]
        kw = {"pre_l1": pre}
    ref_sr, ref_l1 = jax.jit(jmodel.apply)(params, *inputs, **kw)
    sr, l1 = run(tmodel, *inputs, **{k: torch.from_numpy(v)
                                     for k, v in kw.items()})
    assert_close(l1, ref_l1)
    assert_close(sr, ref_sr)


def test_compensate_frames(models):
    """The port returns the unpacked compensated feature; JAX returns its
    quad pack, whose first C channels at the QUAD_PAD offset are the
    feature itself."""
    jmodel, params, tmodel = models
    lrs, _, _, pms, rms, ufs = (a[0] for a in _window(14))
    l1, quad, ufs_p = jax.jit(
        lambda p, *a: jmodel.apply(p, *a, method="compensate_frames"))(
            params, lrs, pms, rms, ufs)
    t_l1, fea_i, t_ufs = run(tmodel.compensate_frames, lrs, pms, rms, ufs)
    qp = QUAD_PAD
    assert_close(t_l1, l1)
    assert_close(fea_i, np.asarray(quad)[:, qp:qp + H, qp:qp + W, :NF])
    assert_close(t_ufs, ufs_p)


def test_config_rejects_settings_outside_the_slice():
    for kw in ({"scan_trunk": True, "fused_egla": True},
               {"scan_trunk": True, "fused_trunk": True},
               {"scan_trunk": True},
               {"use_mv": False}, {"name": "cvsr_v9"},
               {"compute_dtype": torch.float16}):
        with pytest.raises(NotImplementedError):
            ModelConfig(**kw)
    # the sampled EGLA mask is ported; the fused EGLA takes the expected one
    # only (cdfo_tpu ignores fused_egla under the sampled mask)
    assert ModelConfig(mask_mode="sample").mask_mode == "sample"
    with pytest.raises(ValueError, match="fused_egla"):
        ModelConfig(mask_mode="sample", fused_egla=True)
    # trunk_int8 is read only under fused_trunk; block_warp stands alone
    with pytest.raises(ValueError, match="fused_trunk"):
        ModelConfig(trunk_int8=True)
    assert ModelConfig(trunk_int8=True, fused_trunk=True).trunk_int8
    assert ModelConfig(block_warp=True).block_warp
    assert ModelConfig(block_warp=True, fused_egla=True).block_warp
