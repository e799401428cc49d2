"""The port's training slice against cdfo_tpu's, in float32 on the CPU,
then the port's non-finite-loss guard, checkpoints and training CLI.

One JAX model (CVSR_V8, nf 32, 2 trunk groups, 16x16, batch 1, the sampled
EGLA mask) takes two ``cdfo_tpu.train.state.train_step``s from one init;
the port takes two of its own ``train_step``s from the same weights
(``from_flax``), the same batches and the same gumbel draw ``u`` (one numpy
draw, injected into JAX by patching ``jax.random.uniform`` while it
traces). The port runs unfused, and with ``fused_trunk`` (on the CPU the
wrappers' plain forwards and the recompute backwards of ``ops/fused_vjp``),
both against the unfused JAX run, so no interpret-mode kernel runs here.
The losses and every gradient of the first step agree within 1e-4 of the
reference's largest magnitude (max abs error), every parameter after the
second step within 1e-4 relative L2 error. Parameters are held in L2:
Adam moves each weight by about lr whatever its gradient's size, so where a
gradient is near zero at float32's rounding (a sum that cancels) the
update's size and sign are that rounding's, and a single weight's error
reaches ~1e-4 of the tensor's largest one with the port unfused as well
(9.9e-5 in the first step's conv of the trunk, whose gradients agree to
5.5e-7; 1.2e-4 fused), while the tensors agree to a few 1e-6 in L2.

JAX's gradients are read back from its Adam state: after the first update
mu = (1 - b1) (g + wd p), so g = mu / (1 - b1) - wd p, to within the
rounding of that recovery (a few float32 ulps of wd p, which shows where g
is 0: the EGLA mask's convs, which reach the loss only through the
threshold), so the gradients are also given an absolute slack of 1e-6 wd
max |p|.
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from cdfo_tpu.config import ModelConfig as JModelConfig
from cdfo_tpu.config import TrainConfig as JTrainConfig
from cdfo_tpu.models import CVSRV8 as JCVSRV8
from cdfo_tpu.train.state import create_train_state, train_step as j_step
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.config import DataConfig, TrainConfig
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.train import loop as tloop
from cdfo_tpu_torch.train import state as tstate

NF, H, W, B, N = 32, 16, 16, 1, 7
WD = 1e-5


def batch(seed):
    r = np.random.RandomState(seed)
    lrs, pms, rms, ufs = (r.rand(B, N, H, W, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(B, N, H, W, 2) * 1.5).astype(np.float32)
    return {"lrs": lrs, "mvs0": mvs, "mvs1": mvs, "pms": pms, "rms": rms,
            "ufs": ufs,
            "hr": r.rand(B, 4 * H, 4 * W, 1).astype(np.float32)}


GUMBEL_U = np.maximum(np.random.RandomState(7).rand(B * (N - 1), H, W, NF),
                      np.finfo(np.float32).tiny).astype(np.float32)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def assert_close(port, ref, rel=1e-4, what="", atol=0.0):
    port = (port.detach().float().numpy() if isinstance(port, torch.Tensor)
            else np.asarray(port, np.float32))
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max() + atol, (what, err,
                                                   np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train steps: (initial params, losses, first-step gradients,
    params after the second step), each tree in the port's layout."""
    model = JCVSRV8(JModelConfig(nf=NF, scn_groups=2, mask_mode="sample"))
    b0, b1 = batch(1), batch(2)
    state = create_train_state(model, JTrainConfig(), b0)
    init = from_flax(jax.tree.map(np.asarray, state.params))
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == GUMBEL_U.shape:
            return jax.numpy.asarray(GUMBEL_U)
        return real_uniform(key, shape, *args, **kwargs)

    step = jax.jit(j_step)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        state1, loss1 = step(state, b0, jax.random.PRNGKey(0))
        state2, loss2 = step(state1, b1, jax.random.PRNGKey(1))
    mu = from_flax(jax.tree.map(np.asarray, state1.opt_state[1].mu))
    grads = {k: mu[k] / 0.1 - WD * init[k] for k in init}
    final = from_flax(jax.tree.map(np.asarray, state2.params))
    return init, (float(loss1), float(loss2)), grads, final


def port_state(init, **flags):
    model = CVSRV8(ModelConfig(nf=NF, scn_groups=2, mask_mode="sample",
                               **flags),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(init)
    return tstate.TrainState(model, TrainConfig())


@pytest.mark.parametrize("fused_trunk", [False, True])
def test_two_train_steps_match_cdfo_tpu(jax_run, fused_trunk):
    init, losses, grads, final = jax_run
    state = port_state(init, fused_trunk=fused_trunk)
    names = {id(p): n for n, p in state.model.named_parameters()}
    seen = {}
    apply = state.apply_gradients

    def recording_apply():
        if not seen:
            seen.update({names[id(p)]: p.grad.clone() for p in state.params
                         if p.grad is not None})
        apply()

    state.apply_gradients = recording_apply
    u = torch.from_numpy(GUMBEL_U)
    loss1 = tstate.train_step(state, batch(1), gumbel_u=u)
    loss2 = tstate.train_step(state, batch(2), gumbel_u=u)
    assert state.step == 2
    assert_close(loss1, losses[0], what="loss 1")
    assert_close(loss2, losses[1], what="loss 2")
    for name, g in grads.items():
        # a parameter the loss does not reach has no gradient in torch and
        # a zero one in JAX (the EGLA mask's convs: the threshold)
        port_g = seen.get(name, torch.zeros_like(g))
        assert_close(port_g, g, what=f"grad {name}",
                     atol=1e-6 * WD * init[name].abs().max().item())
    sd = state.model.state_dict()
    for name, p in final.items():
        err = ((sd[name] - p).norm() / p.norm()).item()
        assert err <= 1e-4, (f"param {name}", err)


# -- the guard, checkpoints and the CLI (the port alone) -------------------------

def tiny_state(seed=0):
    model = CVSRV8(ModelConfig(nf=16, scn_groups=1, mask_mode="sample",
                               fused_trunk=True),
                   generator=torch.Generator().manual_seed(seed), device="cpu")
    return tstate.TrainState(model, TrainConfig())


def small_batch(bad=False):
    b = {k: v[..., :8, :8, :] if k != "hr" else v[:, :32, :32]
         for k, v in batch(3).items()}
    if bad:
        b["hr"] = b["hr"].copy()
        b["hr"][0, 0, 0, 0] = np.nan
    return b


def snapshot(state):
    return ([p.detach().clone() for p in state.params],
            copy.deepcopy(state.optimizer.state_dict()), state.step)


def assert_same(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    assert a[2] == b[2]


def test_non_finite_loss_skips_the_update():
    """A NaN target: the loss is not finite and the parameters, the
    optimizer state and the step stay; a healthy step after it updates."""
    state = tiny_state()
    gen = torch.Generator().manual_seed(1)
    assert torch.isfinite(tstate.train_step(state, small_batch(), gen))
    before = snapshot(state)
    loss = tstate.train_step(state, small_batch(bad=True), gen)
    assert not torch.isfinite(loss)
    assert_same(snapshot(state), before)
    assert all(p.grad is None for p in state.params)
    assert torch.isfinite(tstate.train_step(state, small_batch(), gen))
    assert state.step == 2
    assert not torch.equal(state.params[0], before[0][0])


def test_checkpoint_roundtrip_and_latest(tmp_path):
    """save -> restore into a fresh state: parameters, optimizer state,
    step and the gumbel generator equal; the next step then runs alike.
    ``latest_checkpoint`` takes the highest step and ignores other files."""
    state, gen = tiny_state(), torch.Generator().manual_seed(2)
    tstate.train_step(state, small_batch(), gen)
    path = tloop.save_checkpoint(str(tmp_path), state, gen)
    assert os.path.basename(path) == "step_00000001.pt"
    fresh, gen2 = tiny_state(seed=9), torch.Generator().manual_seed(7)
    tloop.restore_checkpoint(path, fresh, gen2)
    assert_same(snapshot(fresh), snapshot(state))
    assert torch.equal(gen.get_state(), gen2.get_state())
    assert torch.equal(tstate.train_step(state, small_batch(), gen),
                       tstate.train_step(fresh, small_batch(), gen2))
    for name in ("step_00000010.pt", "step_00000002.pt", "step_x.pt",
                 "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert tloop.latest_checkpoint(str(tmp_path)) == str(
        tmp_path / "step_00000010.pt")
    assert tloop.latest_checkpoint(str(tmp_path / "none")) is None


def test_train_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m cdfo_tpu_torch.tools.train --synthetic --cpu``, in
    process: one epoch writes a checkpoint and a log line; a second run
    with two epochs resumes from it and trains the second."""
    from cdfo_tpu_torch.tools import train as cli
    args = ["--synthetic", "--cpu", "--epochs", "1", "--steps-per-epoch",
            "1", "--ckpt-dir", str(tmp_path)]
    state = cli.main(args)
    assert state.step == 1
    ckpt, log = tloop.run_dirs(TrainConfig(ckpt_dir=str(tmp_path)),
                               DataConfig())
    assert os.listdir(ckpt) == ["step_00000001.pt"]
    args[3] = "2"
    state = cli.main(args)
    assert state.step == 2
    assert "resumed from" in capsys.readouterr().out
    assert sorted(os.listdir(ckpt)) == ["step_00000001.pt",
                                        "step_00000002.pt"]
    lines = [json.loads(x) for x in open(log)]
    assert [x["epoch"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)
    with pytest.raises(NotImplementedError, match="1.6"):
        cli.main(args + ["--scan-trunk"])
