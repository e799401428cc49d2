"""The training slice's parts against cdfo_tpu's, on the CPU: the EGLA
gumbel-sampled mask, the losses, the schedules and the learning rate at
the MultiStepLR boundaries (against optax), and the optimizer's step.

The mask takes one numpy uniform draw in both packages (patched into
``jax.random.uniform``; JAX and torch share no generator); float32 results
agree within 1e-4 of the reference's largest magnitude (the JAX suite's
rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdfo_tpu import losses as jlosses
from cdfo_tpu.config import TrainConfig as JTrainConfig
from cdfo_tpu.models import attention as jattn
from cdfo_tpu.train import schedules as jsched
from cdfo_tpu.train.state import make_schedule as j_make_schedule
from cdfo_tpu_torch import losses as tlosses
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.config import ModelConfig, TrainConfig
from cdfo_tpu_torch.models import attention as tattn
from cdfo_tpu_torch.train import schedules as tsched
from cdfo_tpu_torch.train.state import TrainState, make_schedule

TINY = np.finfo(np.float32).tiny

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def assert_close(port, ref, rel=1e-4):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (err,
                                                       np.abs(ref).max())


# -- the sampled EGLA mask ------------------------------------------------------

def test_sampled_egla_matches_cdfo_tpu(monkeypatch):
    """EGLA(mask_mode='sample') with one u in both: the same output, and a
    mask that is neither all set nor all clear (so the noise decides)."""
    c, shape = 16, (2, 8, 16, 16)
    r = np.random.RandomState(3)
    res, x = (r.randn(*shape).astype(np.float32) for _ in range(2))
    u = np.maximum(r.rand(*shape), TINY).astype(np.float32)
    jmod = jattn.EGLA(c, mask_mode="sample")
    params = jmod.init({"params": jax.random.PRNGKey(0),
                        "gumbel": jax.random.PRNGKey(1)}, res, x)
    params = jax.tree.map(np.array, params)
    real_uniform = jax.random.uniform

    def uniform(key, shp=(), *args, **kwargs):
        if tuple(shp) == shape:
            return jnp.asarray(u)
        return real_uniform(key, shp, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    ref = jmod.apply(params, res, x, rngs={"gumbel": jax.random.PRNGKey(2)})
    tmod = tattn.EGLA(c, mask_mode="sample")
    tmod.load_state_dict(from_flax(params))
    tres, tx, tu = map(torch.from_numpy, (res, x, u))
    with torch.no_grad():
        out = tmod(tres, tx, u=tu)
        mask = tmod.sampled_mask(tres, tx.shape, u=tu)
    assert_close(out, ref)
    assert 0 < mask.mean().item() < 1
    # the gumbel draw decides the mask per pixel: other noise, other bits
    other = tmod.sampled_mask(tres, tx.shape,
                              torch.Generator().manual_seed(0))
    assert not torch.equal(mask, other)


def test_sampled_mask_draws_from_the_generator():
    """The same generator seed gives the same bits; noise is required."""
    tmod = tattn.EGLA(8, mask_mode="sample")
    res = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    masks = [tmod.sampled_mask(res, res.shape,
                               torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(*masks) and masks[0].shape == res.shape
    assert not masks[0].requires_grad
    with pytest.raises(ValueError, match="gumbel"):
        tmod(res, res)


def test_config_takes_the_sampled_mask():
    assert ModelConfig(mask_mode="sample").mask_mode == "sample"
    assert ModelConfig().mask_mode == "expected"
    with pytest.raises(ValueError, match="fused_egla"):
        ModelConfig(mask_mode="sample", fused_egla=True)
    with pytest.raises(ValueError, match="mask_mode"):
        ModelConfig(mask_mode="noisy")


# -- losses ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["charbonnier_loss", "charbonnier_loss_masked",
                                  "mse_loss", "total_variation", "sobel_loss",
                                  "charbonnier_etc_loss"])
def test_losses_match_cdfo_tpu(name):
    r = np.random.RandomState(4)
    five = name == "charbonnier_etc_loss"
    shape = (2, 3, 10, 12, 1) if five else (2, 10, 12, 2)
    x, y = (r.rand(*shape).astype(np.float32) for _ in range(2))
    args = [x] if name == "total_variation" else [x, y]
    if name == "charbonnier_loss_masked":
        args.append((r.rand(*shape) > 0.5).astype(np.float32))
    got = getattr(tlosses, name)(*map(torch.from_numpy, args))
    ref = getattr(jlosses.losses, name)(*map(jnp.asarray, args))
    assert_close(got, ref)


# -- schedules ------------------------------------------------------------------

STEPS = [0, 1, 99, 100, 101, 149, 150, 151, 199, 200, 250, 299, 300, 301,
         450, 600]


def assert_lr(port, ref, base=2e-4):
    """Within 1e-6 of the base lr: JAX evaluates in float32, whose
    1 + cos(...) near a cycle's end keeps only that much of it."""
    assert abs(port - float(ref)) <= 1e-6 * base, (port, float(ref))


def test_multi_step_restart_matches_cdfo_tpu():
    kw = dict(milestones=(100, 200, 400), gamma=0.5, restarts=(0, 300),
              restart_weights=(1.0, 0.7))
    port, ref = (m.multi_step_restart_lr(2e-4, **kw) for m in (tsched, jsched))
    for s in STEPS:
        assert_lr(port(s), ref(s))


def test_cosine_restart_matches_cdfo_tpu():
    kw = dict(periods=(150, 150, 300), restart_weights=(1.0, 0.5, 0.25),
              eta_min=1e-7)
    port, ref = (m.cosine_annealing_restart_lr(2e-4, **kw)
                 for m in (tsched, jsched))
    for s in STEPS:
        assert_lr(port(s), ref(s))


@pytest.mark.parametrize("spe", [1, 7])
def test_lr_at_the_milestone_boundaries_matches_optax(spe):
    """MultiStepLR by epochs as optax evaluates it: milestone m's factor
    applies from update index m * spe on, counted from 0, and the
    optimizer steps with the lr of its own update index."""
    milestones = (3, 5)
    port = make_schedule(TrainConfig(milestones=milestones), spe)
    ref = j_make_schedule(JTrainConfig(milestones=milestones), spe)
    direct = optax.piecewise_constant_schedule(
        1e-4, {m * spe: 0.5 for m in milestones})
    for m in milestones:
        for s in (m * spe - 1, m * spe, m * spe + 1):
            assert_close(port(s), ref(s), rel=1e-6)
            assert_close(port(s), direct(s), rel=1e-6)
    assert port(3 * spe - 1) == 1e-4 and port(3 * spe) == 5e-5
    assert port(5 * spe) == 2.5e-5
    state = TrainState(torch.nn.Linear(2, 2), TrainConfig(milestones=(3,)), spe)
    used = []
    for _ in range(3 * spe + 1):
        used.append(state.schedule(state.step))
        state.apply_gradients()
        assert state.optimizer.param_groups[0]["lr"] == used[-1]
    assert used[3 * spe - 1] == 1e-4 and used[3 * spe] == 5e-5


def test_adam_matches_optax_with_coupled_decay():
    """Two steps of the state's Adam on fixed gradients against optax's
    add_decayed_weights -> scale_by_adam -> scale_by_learning_rate."""
    from cdfo_tpu.train.state import make_optimizer
    cfg = TrainConfig(lr=1e-2, weight_decay=0.1)
    lin = torch.nn.Linear(3, 2)
    state = TrainState(lin, cfg)
    p0 = {n: p.detach().numpy().copy() for n, p in lin.named_parameters()}
    tx = make_optimizer(JTrainConfig(lr=1e-2, weight_decay=0.1))
    params = {n: jnp.asarray(v) for n, v in p0.items()}
    opt = tx.init(params)
    r = np.random.RandomState(5)
    for _ in range(2):
        g = {n: r.randn(*v.shape).astype(np.float32) for n, v in p0.items()}
        for n, p in lin.named_parameters():
            p.grad = torch.from_numpy(g[n])
        state.apply_gradients()
        upd, opt = tx.update({n: jnp.asarray(v) for n, v in g.items()}, opt,
                             params)
        params = optax.apply_updates(params, upd)
    for n, p in lin.named_parameters():
        assert_close(p, params[n], rel=1e-5)
