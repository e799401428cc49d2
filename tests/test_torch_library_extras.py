"""``models/extras.py`` of the port against ``cdfo_tpu``'s in float32 on
the CPU, and the port's profiling and checkpoint tools:

* ``AGGSCGroup`` / ``AGGSCNet`` (on the pyramid blocks), ``RiRGroup`` /
  ``RinRNet``, ``FGSWMSA`` (nearest-warped keys), ``GDN`` forward and
  inverse on a non-symmetric ``gamma`` with its gradient, ``lower_bound``'s
  gradient on both sides of the bound for both signs of the incoming
  gradient (exactly equal to ``jax.grad``'s), ``EMVNet``, ``LocalCorr``,
  ``MotionFeaFusion``, ``ConvUnit``, ``GhostModuleMul`` and ``DSTA``: nf 16
  (``DSTA`` 16 at 32x32, its max pool's size), every zero-initialised
  weight refilled, tolerance 1e-4 of the reference's largest value;
* ``utils.profiling``: ``count_params`` of every registry model equal to
  ``cdfo_tpu``'s on its tree (shapes by ``jax.eval_shape``, no forward),
  ``estimate_flops`` of a 3x3 conv and of a ``Linear`` equal to twice
  their multiply-accumulates, ``Timer`` and ``trace_profile`` on the CPU;
* ``tools.flops --cpu`` in process;
* ``tools.convert_ckpt``: a ``state_dict`` built under the reference
  names into a ``step_%08d.pt`` and back, bit for bit, and its errors.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.models import MODEL_REGISTRY as J_REGISTRY
from cdfo_tpu.models import extras as jex
from cdfo_tpu.utils import count_params as j_count_params
from cdfo_tpu_torch.config import ModelConfig
from cdfo_tpu_torch.models import MODEL_REGISTRY, build_model
from cdfo_tpu_torch.models import extras as tex
from cdfo_tpu_torch.tools import convert_ckpt, flops
from cdfo_tpu_torch.train.loop import latest_checkpoint
from cdfo_tpu_torch.utils import (Timer, count_params, estimate_flops,
                                  trace_profile)
from torch_library_common import (assert_close, jax_params, load, rand, run,
                                  t_)

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
    ref = jax.jit(jm.apply)(params, *args)
    out = run(load(port, params), *args)
    if isinstance(ref, (list, tuple)):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            assert_close(o, r, what=what)
    else:
        assert_close(out, ref, what=what)
    return params


def test_agg_trunks_match_cdfo_tpu():
    """The list-valued AGG group and net on a 3-level pyramid."""
    xs = [rand(1, H, W, NF), rand(1, H // 2, W // 2, NF, seed=1),
          rand(1, H // 4, W // 4, NF, seed=2)]
    params = jax_params(jex.AGGSCGroup(NF, 1), xs)
    out = load(tex.AGGSCGroup(NF, 1), params)
    with torch.no_grad():
        got = out(list(t_(*xs)))
    for o, r in zip(got, jex.AGGSCGroup(NF, 1).apply(params, xs)):
        assert_close(o, r, what="group")
    params = jax_params(jex.AGGSCNet(NF, 1), xs)
    with torch.no_grad():
        got = load(tex.AGGSCNet(NF, 1), params)(list(t_(*xs)))
    for o, r in zip(got, jex.AGGSCNet(NF, 1).apply(params, xs)):
        assert_close(o, r, what="net")


def test_rinr_net_matches_cdfo_tpu():
    check(jex.RinRNet(NF, 2), tex.RinRNet(NF, 2), rand(1, H, W, NF))


@pytest.mark.parametrize("with_flow", [True, False])
def test_fgsw_msa_matches_cdfo_tpu(with_flow):
    """Flows of whole and half pixels (nearest rounds half to even), some
    out of the image; and no flow."""
    q, kf, kr = (rand(1, H, W, NF, seed=s) for s in range(3))
    flow = np.round(rand(1, H, W, 2, seed=3, scale=3.0) * 2) / 2
    jm = jex.FGSWMSA(NF, dim_head=8, heads=2)
    port = tex.FGSWMSA(NF, dim_head=8, heads=2)
    if with_flow:
        check(jm, port, q, kf, kr, flow)
    else:
        params = jax_params(jm, q, kf, kr, flow)
        with torch.no_grad():
            out = load(port, params)(*t_(q, kf, kr), None)
        assert_close(out, jm.apply(params, q, kf, kr, None))


def test_lower_bound_gradient_equals_jax():
    """Below, at and above the bound, with incoming gradients of both
    signs: the gradient passes where x >= bound or g < 0, exactly."""
    x = np.array([0.5, 1.0, 2.0, 0.5, 1.0, 2.0, -3.0], np.float32)
    g = np.array([1.0, 1.0, 1.0, -1.0, -2.0, -0.5, 0.25], np.float32)
    ref = jax.grad(lambda v: jnp.sum(jex.lower_bound(v, 1.0) * g))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = tex.lower_bound(xt, 1.0)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jex.lower_bound(x, 1.0)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  [0, 1, 1, -1, -2, -0.5, 0])


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_and_its_gradient_match_cdfo_tpu(inverse):
    """A non-symmetric ``gamma`` (a transposed one would not pass) and a
    ``beta`` with entries under its bound, the gradients of the input and
    of both parameters against ``jax.grad``'s."""
    x = rand(2, 8, 8, NF)
    jm = jex.GDN(NF, inverse=inverse)
    params = jax_params(jm, x)
    r = np.random.RandomState(4)
    p = params["params"]
    p["gamma"] = np.abs(r.randn(NF, NF) * 0.1).astype(np.float32)
    p["beta"] = r.uniform(-0.2, 1.5, NF).astype(np.float32)
    assert np.abs(p["gamma"] - p["gamma"].T).max() > 0.05
    port = load(tex.GDN(NF, inverse=inverse), params)
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    assert_close(out, jm.apply(params, x))
    cot = rand(2, 8, 8, NF, seed=9)

    def loss(pp, xx):
        return jnp.sum(jm.apply(pp, xx) * cot)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    (out * torch.from_numpy(cot)).sum().backward()
    assert_close(xt.grad, gx, what="x")
    assert_close(port.beta.grad, gp["params"]["beta"], what="beta")
    assert_close(port.gamma.grad, np.asarray(gp["params"]["gamma"]).T,
                 what="gamma")


def test_emvnet_matches_cdfo_tpu():
    check(jex.EMVNet(NF), tex.EMVNet(NF), rand(1, H, W, 2, scale=2.0))


def test_local_corr_matches_cdfo_tpu():
    ref = rand(2, H, W, NF)
    nbrs = [rand(2, H, W, NF, seed=s) for s in (1, 2)]
    jm = jex.LocalCorr(NF)
    out = tex.LocalCorr(NF)(list(t_(*nbrs)), *t_(ref))
    assert_close(out, jm.apply({}, nbrs, ref))


@pytest.mark.parametrize("name", ["fusion", "unit_relu", "unit_lrelu",
                                  "ghost"])
def test_small_extras_match_cdfo_tpu(name):
    a, b = rand(1, H, W, NF), rand(1, H, W, NF, seed=1)
    j, t, args = {
        "fusion": (jex.MotionFeaFusion(NF), tex.MotionFeaFusion(NF), (a, b)),
        "unit_relu": (jex.ConvUnit(8, 3, 1, 1), tex.ConvUnit(NF, 8, 3, 1, 1),
                      (a,)),
        "unit_lrelu": (jex.ConvUnit(NF, 3, 2, 1, groups=4, act_type="lrelu"),
                       tex.ConvUnit(NF, NF, 3, 2, 1, groups=4,
                                    act_type="lrelu"), (a,)),
        "ghost": (jex.GhostModuleMul(NF, NF, 3), tex.GhostModuleMul(NF, NF, 3),
                  (a,)),
    }[name]
    check(j, t, *args, what=name)


def test_deformable_saliency_attention_matches_cdfo_tpu():
    """``DSTA`` at 32x32 (its 7/3 max pool leaves a 4x4 map), its
    ``dcn_bias`` refilled."""
    params = check(jex.DSTA(NF), tex.DSTA(NF), rand(1, 32, 32, NF))
    assert params["params"]["dcn_bias"].any()


# -- profiling, the flops tool, convert_ckpt ---------------------------------

def test_count_params_equals_cdfo_tpu_for_every_registry_name():
    """cdfo_tpu's ``count_params`` of each registry model's tree (its
    shapes from ``jax.eval_shape`` of ``init``, as zero arrays) equals the
    port's of the same name."""
    assert set(MODEL_REGISTRY) == set(J_REGISTRY)
    x = jax.ShapeDtypeStruct((1, 7, 16, 16, 1), jnp.float32)
    mv = jax.ShapeDtypeStruct((1, 7, 16, 16, 2), jnp.float32)
    keys = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)}
    for name in J_REGISTRY:
        jm = J_REGISTRY[name]()
        xs = (x, mv, mv, x, x, x)
        if name == "sidecvsr":
            xs = xs[:2] + xs[3:]
        shapes = jax.eval_shape(lambda *a: jm.init(keys, *a), *xs)
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        port = build_model(name, device="cpu")
        assert count_params(port) == j_count_params(zeros), name


def test_estimate_flops_counts_two_per_multiply_accumulate():
    conv = torch.nn.Conv2d(16, 24, 3, padding=1)
    x = torch.randn(2, 16, 10, 12)
    assert estimate_flops(conv, x) == 2 * (2 * 10 * 12) * 24 * 16 * 9
    lin = torch.nn.Linear(40, 24)
    assert estimate_flops(lin, torch.randn(5, 40)) == 2 * 5 * 40 * 24


def test_timer_and_trace_profile_on_the_cpu(tmp_path):
    timer = Timer("cpu")
    times = timer.time(lambda: torch.ones(64, 64) @ torch.ones(64, 64),
                       reps=3, warmup=1)
    assert len(times) == 3 and all(t > 0 for t in times)
    with timer.measure():
        torch.ones(8).sum()
    assert len(timer.times) == 4 and timer.mean > 0
    assert timer.sync(5) == 5
    with trace_profile(str(tmp_path)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert traces
    with open(tmp_path / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_flops_tool_runs_on_the_cpu(capsys):
    out = flops.main(["--model", "cvsr_v8", "--hw", "16", "16", "--cpu"])
    assert out["params"] == count_params(build_model("cvsr_v8",
                                                     device="cpu"))
    assert out["gflop"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    small = flops.count("sidecvsr", 16, 16, "cpu",
                        ModelConfig(name="sidecvsr", nf=16, scn_groups=1))
    assert 0 < small["gflop"] < out["gflop"]


def _reference_state_dict(cfg, seed=7):
    """A ``state_dict`` under the reference names (float32 CPU tensors of
    seeded values) with one of its dead keys, as a released ``.pth``
    holds."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g)
          for k, v in build_model(cfg.name, cfg, device="cpu")
          .state_dict().items()}
    sd["MV_deform_align.fusion_in.0.weight"] = torch.zeros(3)
    return sd


def test_convert_ckpt_round_trip_is_bit_equal(tmp_path):
    cfg = ModelConfig(nf=16, scn_groups=1)
    sd = _reference_state_dict(cfg)
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": sd}, pth)
    path = convert_ckpt.pth_to_checkpoint(
        convert_ckpt.load_torch_checkpoint(str(pth)), str(tmp_path / "ckpt"),
        step=12, cfg=cfg)
    assert os.path.basename(path) == "step_00000012.pt"
    assert latest_checkpoint(str(tmp_path / "ckpt")) == path
    blob = torch.load(path, weights_only=True)
    assert blob["step"] == 12 and "optimizer" in blob
    back = convert_ckpt.checkpoint_to_state_dict(path, cfg=cfg)
    live = {k: v for k, v in sd.items() if "fusion_in" not in k}
    assert set(back) == set(live)
    for k, v in live.items():
        assert torch.equal(back[k], v), k


def test_convert_ckpt_cli_and_its_errors(tmp_path):
    cfg = ModelConfig(nf=16, scn_groups=1)
    sd = _reference_state_dict(cfg)
    wrong = dict(sd)
    wrong["no_such_layer.weight"] = torch.zeros(1)
    del wrong["conv_first.weight"]
    with pytest.raises(KeyError, match="no_such_layer.*conv_first"):
        convert_ckpt.pth_to_checkpoint(wrong, str(tmp_path), cfg=cfg)
    ckpt = convert_ckpt.pth_to_checkpoint(sd, str(tmp_path / "c"), cfg=cfg)
    with pytest.raises(KeyError, match="missing|lacks"):
        convert_ckpt.checkpoint_to_state_dict(
            ckpt, cfg=ModelConfig(nf=16, scn_groups=2))
    full = build_model("cvsr_v8", device="cpu").state_dict()
    pth = tmp_path / "full.pth"
    torch.save(full, pth)
    path = convert_ckpt.main(["--pth", str(pth), "--out",
                              str(tmp_path / "cli")])
    out = tmp_path / "back.pth"
    convert_ckpt.main(["--inverse", "--ckpt", path, "--out", str(out)])
    back = torch.load(out, weights_only=True)
    assert set(back) == set(full)
    assert all(torch.equal(back[k], full[k].float()) for k in full)
