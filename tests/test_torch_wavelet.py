"""The port's multi-wavelet contrastive loss (``cdfo_tpu_torch/losses/
wavelet.py``) against ``cdfo_tpu/losses/wavelet.py``, float32 on the CPU:

- ``haar_dwt`` and ``wave_decompose`` at even and odd sizes within 1e-6;
- ``charbonnier_fcl_loss`` with the port's LPIPS (vgg, ``cdfo_tpu``'s
  params carried across) against ``cdfo_tpu``'s with its LPIPS, ``neg=3``,
  within 1e-4 relative. The shuffles' draws differ (a torch generator
  against JAX's key); they do not move the value, since a shuffle permutes
  both sides of a pair alike (checked here: two generators, one value);
- its gradient equals ``charbonnier_loss``'s, as the contrastive term is
  detached (``stop_gradient`` in ``cdfo_tpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.losses import wavelet as jw
from cdfo_tpu.metrics.lpips import LPIPS as JLPIPS
from cdfo_tpu_torch.compat import lpips_from_flax
from cdfo_tpu_torch.losses import charbonnier_loss
from cdfo_tpu_torch.losses import wavelet as tw
from cdfo_tpu_torch.metrics.lpips import LPIPS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(2, 8, 12, 1), (2, 7, 9, 3), (1, 5, 6, 2)])
def test_haar_dwt_matches(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    for got, want in zip(tw.haar_dwt(torch.from_numpy(x)), jw.haar_dwt(x)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    (gh, gl), (wh, wl) = tw.wave_decompose(torch.from_numpy(x)), \
        jw.wave_decompose(jnp.asarray(x))
    for got, want in zip(gh + gl, wh + wl):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.fixture(scope="module")
def lpips_pair():
    x = np.zeros((1, 32, 32, 3), np.float32)
    jm = JLPIPS(net="vgg")
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                       x, x))
    for k in params["params"]:
        if k.startswith("lin"):
            params["params"][k]["kernel"] = np.abs(params["params"][k]["kernel"])
    tm = LPIPS("vgg", device="cpu")
    tm.load_state_dict(lpips_from_flax(params, "vgg"), strict=False)
    apply = jax.jit(jm.apply)
    return (lambda a, b: apply(params, a, b)), tm


def frames(seed, b=4, h=32, w=32):
    r = np.random.RandomState(seed)
    hr = r.rand(b, h, w, 1).astype(np.float32)
    sr = np.clip(hr + r.randn(b, h, w, 1).astype(np.float32) * 0.05, 0, 1)
    lr_up = np.clip(hr + r.randn(b, h, w, 1).astype(np.float32) * 0.2, 0, 1)
    return sr, hr, lr_up


def test_fcl_loss_matches_cdfo_tpu(lpips_pair):
    jfn, tm = lpips_pair
    sr, hr, lr_up = frames(1)
    want = float(jw.charbonnier_fcl_loss(sr, hr, lr_up, jfn,
                                         rng=jax.random.PRNGKey(3)))
    got = tw.charbonnier_fcl_loss(
        torch.from_numpy(sr), torch.from_numpy(hr), torch.from_numpy(lr_up),
        tm, generator=torch.Generator().manual_seed(5))
    assert abs(got.item() - want) <= 1e-4 * abs(want), (got.item(), want)
    contrast = [tw.multiwave_contrastive_loss(
        torch.from_numpy(sr), torch.from_numpy(lr_up), torch.from_numpy(hr),
        tm, neg=3, generator=torch.Generator().manual_seed(s)).item()
        for s in (0, 1)]
    jc = float(jw.multiwave_contrastive_loss(sr, lr_up, hr, jfn, neg=3))
    np.testing.assert_allclose(contrast, [jc, jc], rtol=1e-4)
    assert contrast[0] > 0


def test_fcl_gradient_is_charbonnier_gradient(lpips_pair):
    _, tm = lpips_pair
    sr, hr, lr_up = (torch.from_numpy(a) for a in frames(2))
    a = sr.clone().requires_grad_()
    tw.charbonnier_fcl_loss(a, hr, lr_up, tm).backward()
    b = sr.clone().requires_grad_()
    charbonnier_loss(b, hr).backward()
    assert torch.equal(a.grad, b.grad)
    assert all(p.grad is None for p in tm.parameters())
