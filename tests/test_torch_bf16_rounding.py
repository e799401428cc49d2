"""Does the port's eager bfloat16 path round where ``cdfo_tpu``'s does not?

On the card the eager bf16 model (plain trunk) loses ~1.4 dB more against
its float32 self than the one with the fused trunk, whose ``Block_`` keeps
its sums in float32. These tests hold the port's bf16 plain trunk
(``models/trunk.py::SCNetS``) and its whole bf16 plain CVSR_V8 against
``cdfo_tpu``'s bf16 ``SCNetS`` / ``CVSRV8`` on the same weights
(``from_flax``) and inputs, bf16 against bf16, each also against the
float32 model: the port's bf16 error must be no larger than
``cdfo_tpu``'s (within 10%), and the two bf16 outputs as close to each
other as bf16 rounding puts either from float32. They are: the port rounds
no more than ``cdfo_tpu``, so the loss is the eager bf16 path's own
rounding (a bf16 result after every conv, resize and residual add of the
three-branch ``Block_``), which both packages share.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.models import trunk as jtrunk
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.models import trunk as ttrunk

NF, GROUPS, H, W = 32, 2, 16, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def load(module, params):
    """``from_flax``'s float32 weights in the module's own dtypes."""
    own = module.state_dict()
    module.load_state_dict({k: v.to(own[k].dtype)
                            for k, v in from_flax(params).items()})
    return module.eval()


def check_rounding(ref, jax_bf16, port_bf16) -> None:
    jax_err, port_err = rms(jax_bf16, ref), rms(port_bf16, ref)
    print(f"rms error against float32: cdfo_tpu bf16 {jax_err:.6g}, port "
          f"bf16 {port_err:.6g}; port against cdfo_tpu "
          f"{rms(port_bf16, jax_bf16):.6g} (largest float32 value "
          f"{np.abs(ref).max():.6g})")
    assert jax_err > 0 and port_err <= 1.1 * jax_err, (port_err, jax_err)
    assert rms(port_bf16, jax_bf16) <= 2.0 * jax_err, \
        (rms(port_bf16, jax_bf16), jax_err)


def test_bf16_plain_trunk_rounds_no_more_than_cdfo_tpu():
    x = np.random.RandomState(0).randn(2, H, W, NF).astype(np.float32)
    j32 = jtrunk.SCNetS(NF, GROUPS)
    params = jax.tree.map(np.array,
                          jax.jit(j32.init)(jax.random.PRNGKey(0), x))
    ref = np.asarray(jax.jit(j32.apply)(params, x))
    j16 = jtrunk.SCNetS(NF, GROUPS, dtype=jnp.bfloat16)
    jax_bf16 = np.asarray(jax.jit(j16.apply)(
        params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    port = load(ttrunk.SCNetS(NF, GROUPS, dtype=torch.bfloat16), params)
    with torch.no_grad():
        port_bf16 = port(torch.from_numpy(x).bfloat16()).float().numpy()
    check_rounding(ref, jax_bf16, port_bf16)


def test_bf16_plain_model_rounds_no_more_than_cdfo_tpu():
    cfg = dict(nf=NF, scn_groups=GROUPS, mask_mode="expected")
    d = np.zeros((1, 7, H, W, 1), np.float32)
    dm = np.zeros((1, 7, H, W, 2), np.float32)
    j32 = JCVSRV8(JModelConfig(**cfg))
    params = jax.tree.map(np.array, jax.jit(j32.init)(
        jax.random.PRNGKey(0), d, dm, dm, d, d, d))
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    r = np.random.RandomState(12)
    lrs, pms, rms_, ufs = (r.rand(2, 7, H, W, 1).astype(np.float32)
                           for _ in range(4))
    mvs = (r.randn(2, 7, H, W, 2) * 2).astype(np.float32)
    inputs = (lrs, mvs, mvs, pms, rms_, ufs)
    ref = np.asarray(jax.jit(j32.apply)(params, *inputs)[0])
    j16 = JCVSRV8(JModelConfig(**cfg, compute_dtype=jnp.bfloat16))
    jax_bf16 = np.asarray(jax.jit(j16.apply)(params, *inputs)[0],
                          np.float32)
    port = load(CVSRV8(ModelConfig(**cfg, compute_dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0), device="cpu"),
                params)
    with torch.no_grad():
        port_bf16 = port(*map(torch.from_numpy, inputs))[0].numpy()
    check_rounding(ref, jax_bf16, port_bf16)
