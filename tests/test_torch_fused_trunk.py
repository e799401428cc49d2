"""The port's fused-trunk path (``ModelConfig(fused_trunk=True)``) against
cdfo_tpu's, in float32 on the CPU.

* Each kernel's plain PyTorch version against the JAX Pallas kernel it
  ports, run as ``tests/test_fused_kernels.py`` runs it (interpret mode on
  the CPU), and against its XLA twin in ``cdfo_tpu/ops/fused_vjp.py`` at a
  second shape. The plain versions are not tied to C = 64, so the
  ``Block_`` and tail run narrow.
* ``fold_down_conv2``'s algebra, the weight trees, the wrappers' refusals
  (odd extents; on the card, autograd outside ``ops/fused_vjp``'s
  Functions; the tail, which has no backward) and the Functions' gradients
  against the JAX twins' vjp.
* The port's fused engine against the JAX engine (``fused_trunk=False``,
  which ``tests/test_engine.py`` pins equal to the fused one): uint8 frames
  within 1 LSB.
* The library hash of ``ops/cuda_build.py`` covers the shared headers.

Inputs come from numpy seeds; kernels agree within 1e-4 of the reference's
largest magnitude (the JAX suite's rule).
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
from cdfo_tpu.ops import fused_vjp
from cdfo_tpu.ops.fused_block import dual_weights
from cdfo_tpu.ops.fused_block2 import fused_scale_block
from cdfo_tpu.ops.fused_groupconv import conv3x3_residual_hcw
from cdfo_tpu.ops.fused_head import fused_head as j_fused_head
from cdfo_tpu.ops.fused_tail import resblock_pair_hcw
from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.compat import from_flax
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.ops import cuda_build
from cdfo_tpu_torch.ops import fused_vjp as tvjp
from cdfo_tpu_torch.ops.fused_block2 import (fold_down_conv2, scale_block,
                                             scale_block_plain)
from cdfo_tpu_torch.ops.fused_groupconv import grouptail, grouptail_plain
from cdfo_tpu_torch.ops.fused_head import fused_head, fused_head_plain
from cdfo_tpu_torch.ops.fused_tail import resblock_pair, resblock_pair_plain


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
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def hwio(r, kh, kw, cin, cout, scale):
    return (r.randn(kh, kw, cin, cout) * scale).astype(np.float32)


def vec(r, n, scale=0.1):
    return (r.randn(n) * scale).astype(np.float32)


def t_conv(k):
    """HWIO -> torch (out, in, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def hcw(a):
    """NHWC numpy -> the JAX kernels' row-major (B, H, C, W)."""
    return jnp.asarray(np.transpose(a, (0, 1, 3, 2)))


# -- Block_ -------------------------------------------------------------------

def _block_weights(seed, c):
    r = np.random.RandomState(seed)
    return (hwio(r, 3, 3, c, 4 * c, 0.1), vec(r, 4 * c),
            hwio(r, 3, 3, 4 * c, c, 0.1), vec(r, c),
            hwio(r, 1, 1, c, c, 0.3), vec(r, c),
            hwio(r, 1, 1, c, c, 0.3), vec(r, c))


def _block_port(x, k1, b1, k2, b2, kd, bd, ku, bu):
    with torch.no_grad():
        return scale_block(t_(x), t_conv(k1), t_(b1), t_conv(k2), t_(b2),
                           t_conv(kd), t_(bd), t_conv(ku), t_(bu))


def test_block_plain_matches_pallas_kernel():
    b, h, w, c = 2, 20, 30, 8
    x = np.random.RandomState(0).randn(b, h, w, c).astype(np.float32)
    k1, b1, k2, b2, kd, bd, ku, bu = _block_weights(1, c)
    ref = fused_scale_block(jnp.asarray(x), k1, b1, k2, b2, kd, bd, ku, bu,
                            rows=4, wt=128)
    assert_close(_block_port(x, k1, b1, k2, b2, kd, bd, ku, bu), ref)


def test_block_plain_matches_xla_twin():
    b, h, w, c = 1, 12, 18, 16
    x = np.random.RandomState(2).randn(b, h, w, c).astype(np.float32)
    ws = _block_weights(3, c)
    ref = fused_vjp._block_twin(hcw(x), *map(jnp.asarray, ws))
    assert_close(_block_port(x, *ws), np.transpose(np.asarray(ref),
                                                   (0, 1, 3, 2)))


def test_fold_down_conv2_is_down2_after_conv2():
    """The folded stride-2 4x4 conv equals conv2 at 2x (zero-padded) and
    then the 2x2 mean, which is what bilinear 0.5x is."""
    g = torch.Generator().manual_seed(0)
    w2 = torch.randn(8, 32, 3, 3, generator=g, dtype=torch.float64)
    y2 = torch.randn(2, 32, 14, 10, generator=g, dtype=torch.float64)
    ref = torch.nn.functional.avg_pool2d(
        torch.nn.functional.conv2d(y2, w2, padding=1), 2)
    got = torch.nn.functional.conv2d(y2, fold_down_conv2(w2).double(),
                                     stride=2, padding=1)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def _on_card_without_launching(monkeypatch):
    """The wrappers' card route, stopped before any launch (a CPU test
    cannot launch)."""
    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(cuda_build, "on_card", lambda t, what: True)
    monkeypatch.setattr(cuda_build, "launch", no_launch)


def _grads_against_twin(port_fn, twin, arrays, layouts, seed):
    """port_fn's gradients (every argument requiring grad) against
    ``jax.vjp(twin)`` on the same arrays: layouts per argument, "x" NHWC
    (the twin's HCW), "w" a torch conv weight (the twin's HWIO), "v" as
    it is."""
    tensors = [t_(a).requires_grad_() for a in arrays]
    out = port_fn(*[t_conv(t.detach().numpy()).requires_grad_() if k == "w"
                    else t for t, k in zip(tensors, layouts)])
    g = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jin = [hcw(a) if k == "x" else jnp.asarray(a)
           for a, k in zip(arrays, layouts)]
    ref = jax.jit(lambda c, *x: jax.vjp(twin, *x)[1](c))(hcw(g), *jin)
    out.backward(t_(g))
    return out, ref


def test_block_refuses_odd_extents_and_grad(monkeypatch):
    """Odd extents are refused. The gradient flows through
    ``fused_vjp.block_fused`` and equals JAX's recompute backward (the vjp
    of ``_block_twin``); on the card the bare wrapper under autograd
    refuses, pointing to that Function (its launch would carry no
    grad_fn)."""
    c = 8
    ws = _block_weights(4, c)
    tws = [t_conv(k) if k.ndim == 4 else t_(k) for k in ws]
    with torch.no_grad(), pytest.raises(ValueError, match="even"):
        scale_block(torch.zeros(1, 6, 7, c), *tws)
    x = np.random.RandomState(5).randn(1, 6, 8, c).astype(np.float32)
    layouts = ["x"] + ["w" if k.ndim == 4 else "v" for k in ws]
    grads = {}

    def port(xt, *params):
        for i, p in enumerate(params):
            p.register_hook(lambda gr, i=i: grads.__setitem__(i, gr))
        xt.register_hook(lambda gr: grads.__setitem__("x", gr))
        return tvjp.block_fused(xt, *params)

    _, ref = _grads_against_twin(port, fused_vjp._block_twin, [x, *ws],
                                 layouts, 6)
    assert_close(grads["x"], np.transpose(np.asarray(ref[0]), (0, 1, 3, 2)))
    for i, (k, r) in enumerate(zip(ws, ref[1:])):
        r = np.asarray(r)
        assert_close(grads[i], np.transpose(r, (3, 2, 0, 1))
                     if k.ndim == 4 else r)
    _on_card_without_launching(monkeypatch)
    with pytest.raises(RuntimeError, match="fused_vjp.block_fused"):
        scale_block(t_(x).requires_grad_(), *tws)


# -- SCGroup tail ----------------------------------------------------------------

def _group_case(seed, b, h, w, c):
    r = np.random.RandomState(seed)
    x, skip = (r.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    return x, skip, hwio(r, 3, 3, c, c, 0.1), vec(r, c)


def test_grouptail_plain_matches_pallas_kernel():
    x, skip, kg, bg = _group_case(5, 2, 12, 30, 8)
    h, w = x.shape[1:3]
    gp = jnp.pad(hcw(x), ((0, 0), (1, 1), (0, 0), (2, 126 + 128 - w)))
    sp = jnp.pad(hcw(skip), ((0, 0), (0, 0), (0, 0), (0, 128 - w)))
    out = conv3x3_residual_hcw(gp, sp, dual_weights(jnp.asarray(kg)),
                               jnp.asarray(bg).reshape(-1, 1), img_h=h,
                               img_w=w, rows=4, wt=128)
    ref = np.transpose(np.asarray(out[:, :h, :, :w]), (0, 1, 3, 2))
    with torch.no_grad():
        got = grouptail(t_(x), t_(skip), t_conv(kg), t_(bg))
    assert_close(got, ref)


def test_grouptail_plain_matches_xla_twin():
    x, skip, kg, bg = _group_case(6, 1, 9, 13, 64)
    ref = fused_vjp._grouptail_twin(hcw(x), hcw(skip), jnp.asarray(kg),
                                    jnp.asarray(bg))
    got = grouptail_plain(t_(x), t_(skip), t_conv(kg), t_(bg))
    assert_close(got, np.transpose(np.asarray(ref), (0, 1, 3, 2)))


# -- upsample head ---------------------------------------------------------------

def _head_case(seed, b, h, w, nf=64):
    r = np.random.RandomState(seed)
    t = r.randn(b, h, w, nf).astype(np.float32)
    lr = r.rand(b, h, w, 1).astype(np.float32)
    ws = (hwio(r, 1, 1, nf, 4 * nf, 0.1), vec(r, 4 * nf),
          hwio(r, 1, 1, nf, 4 * nf, 0.1), vec(r, 4 * nf),
          hwio(r, 3, 3, nf, 1, 0.1), vec(r, 1))
    return t, lr, ws


def _head_port(t, lr, ws, fn=fused_head):
    k1, b1, k2, b2, kl, bl = ws
    with torch.no_grad():
        return fn(t_(t), t_(lr), t_conv(k1), t_(b1), t_conv(k2), t_(b2),
                  t_conv(kl), t_(bl))


def test_head_plain_matches_pallas_kernel():
    t, lr, ws = _head_case(7, 2, 16, 24)
    ref = j_fused_head(hcw(t), jnp.asarray(lr), *map(jnp.asarray, ws),
                       rows=4, wt=128)
    assert_close(_head_port(t, lr, ws), ref)


def test_head_plain_matches_xla_twin():
    t, lr, ws = _head_case(8, 1, 7, 11)
    ref = fused_vjp._head_twin(hcw(t), jnp.asarray(lr),
                               *map(jnp.asarray, ws))
    assert_close(_head_port(t, lr, ws, fused_head_plain), ref)


# -- alignment tail -------------------------------------------------------------

def _tail_case(seed, bc, nbr, h, w, c):
    r = np.random.RandomState(seed)
    x = r.randn(bc * nbr, h, w, c).astype(np.float32)
    center = r.randn(bc, h, w, c).astype(np.float32)
    gate = r.rand(bc * nbr, c).astype(np.float32)
    ws = [hwio(r, 3, 3, c, c, 0.1) for _ in range(4)]
    bs = [vec(r, c) for _ in range(4)]
    return x, center, gate, ws, bs


def _tail_port(x, center, gate, ws, bs, fn=resblock_pair):
    args = [a for pair in zip(map(t_conv, ws), map(t_, bs)) for a in pair]
    with torch.no_grad():
        return fn(t_(x), t_(center), t_(gate), *args)


def test_tail_plain_matches_pallas_kernel():
    x, center, gate, ws, bs = _tail_case(9, 2, 3, 12, 30, 8)
    h, w = x.shape[1:3]
    tp = jnp.pad(hcw(x), ((0, 0), (4, 4), (0, 0), (4, 124 + 128 - w)))
    sk = jnp.pad(hcw(center), ((0, 0), (0, 0), (0, 0), (0, 128 - w)))
    dual = [a for k, b in zip(ws, bs)
            for a in (dual_weights(jnp.asarray(k)), jnp.asarray(b)[:, None])]
    out = resblock_pair_hcw(tp, sk, *dual, img_h=h, img_w=w, nbr=3, rows=4,
                            wt=128, gate=jnp.asarray(gate))
    ref = np.transpose(np.asarray(out[:, :h, :, :w]), (0, 1, 3, 2))
    assert_close(_tail_port(x, center, gate, ws, bs), ref)


def test_tail_plain_matches_xla_composition():
    """RB2(RB1(gate * x)) + center[b // nbr] written out in XLA (the tail
    has no twin in fused_vjp)."""
    x, center, gate, ws, bs = _tail_case(10, 2, 2, 9, 11, 64)

    def conv(t, k, b):
        return jax.lax.conv_general_dilated(
            t, jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    t = jnp.asarray(x) * jnp.asarray(gate)[:, None, None, :]
    for i in (0, 2):
        t = t + conv(jax.nn.relu(conv(t, ws[i], bs[i])), ws[i + 1], bs[i + 1])
    ref = t + jnp.repeat(jnp.asarray(center), 2, axis=0)
    assert_close(_tail_port(x, center, gate, ws, bs, resblock_pair_plain),
                 ref)


def test_wrappers_refuse_grad(monkeypatch):
    """The alignment tail has no backward in cdfo_tpu either: under
    autograd it refuses. The group tail trains: its gradient through
    ``fused_vjp.grouptail_fused`` equals the vjp of ``_grouptail_twin``,
    and on the card the bare wrapper under autograd refuses, pointing to
    that Function."""
    x = torch.zeros(2, 4, 4, 8, requires_grad=True)
    w = torch.zeros(8, 8, 3, 3)
    b = torch.zeros(8)
    with pytest.raises(NotImplementedError, match="no backward"):
        resblock_pair(x, x[:1], torch.ones(2, 8), *([w, b] * 4))
    xs, skip, kg, bg = _group_case(7, 2, 5, 6, 8)
    grads = {}

    def port(*ts):
        for i, t in enumerate(ts):
            t.register_hook(lambda gr, i=i: grads.__setitem__(i, gr))
        return tvjp.grouptail_fused(*ts)

    _, ref = _grads_against_twin(port, fused_vjp._grouptail_twin,
                                 [xs, skip, kg, bg], ["x", "x", "w", "v"], 8)
    for i, back in enumerate([(0, 1, 3, 2), (0, 1, 3, 2), (3, 2, 0, 1), None]):
        r = np.asarray(ref[i])
        assert_close(grads[i], r if back is None else np.transpose(r, back))
    _on_card_without_launching(monkeypatch)
    with pytest.raises(RuntimeError, match="fused_vjp.grouptail_fused"):
        grouptail(x, x, w, b)


# -- the model and the engine ------------------------------------------------------

NF, T, H, W = 32, 9, 16, 24


@pytest.fixture(scope="module")
def setup():
    """One set of JAX weights from the unfused JAX model, in a fused port
    model; the JAX fused model's tree must be the same."""
    d = np.zeros((1, 7, H, W, 1), np.float32)
    dm = np.zeros((1, 7, H, W, 2), np.float32)
    trees = {}
    for fused in (False, True):
        jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=2,
                                      mask_mode="expected",
                                      fused_trunk=fused))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), d, dm,
                                dm, d, d, d)
        trees[fused] = jax.tree_util.tree_map(lambda s: (s.shape, s.dtype),
                                              shapes)
    jmodel = JCVSRV8(JModelConfig(nf=NF, scn_groups=2, mask_mode="expected"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), d, dm, dm, d, d, d)
    params = jax.tree.map(np.array, params)
    params["params"]["RDAB"]["conv_du_re2_0"]["conv"]["bias"][3] += 10.0
    tmodel = CVSRV8(ModelConfig(nf=NF, scn_groups=2, fused_trunk=True),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tmodel.load_state_dict(from_flax(params))
    return trees, jmodel, params, tmodel


def test_weight_trees_match(setup):
    trees, _, params, _ = setup
    assert trees[False] == trees[True]
    sd = from_flax(params)
    for fused in (False, True):
        model = CVSRV8(ModelConfig(nf=NF, scn_groups=2, fused_trunk=fused),
                       generator=torch.Generator().manual_seed(1),
                       device="cpu")
        model.load_state_dict(sd, strict=True)
        assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("k", [1, 4])
def test_fused_engine_matches_jax_engine(setup, k):
    _, jmodel, params, tmodel = setup
    ref, _ = JEngine(jmodel, params, k=k).run_sequence(
        j_synthetic(t=T, h=H, w=W, seed=3))
    frames, _ = BatchedStreamingEngine(tmodel, k=k).run_sequence(
        synthetic_sequence(t=T, h=H, w=W, seed=3))
    assert frames.shape == ref.shape == (T, 4 * H, 4 * W)
    diff = np.abs(frames.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, (k, diff.max(), (diff > 1).sum())
    assert frames.std() > 0


def test_config_takes_fused_trunk_and_refuses_int8():
    assert ModelConfig(fused_trunk=True,
                       compute_dtype=torch.bfloat16).fused_trunk
    # the int8 trunk is a kernel of the fused trunk
    assert ModelConfig(fused_trunk=True, trunk_int8=True).trunk_int8
    with pytest.raises(ValueError, match="fused_trunk"):
        ModelConfig(trunk_int8=True)
    # cdfo_tpu ignores the scan trunk under the fused trunk
    with pytest.raises(ValueError, match="scan trunk under the fused trunk"):
        ModelConfig(fused_trunk=True, scan_trunk=True)


# -- the build --------------------------------------------------------------------

def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """A library's name hashes every .cu and .cuh under csrc/, so editing a
    header its source includes gives a new library, never a stale one."""
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")
    assert first.parent == tmp_path / "build" and first.name.startswith("k-")
    (tmp_path / "tile.cuh").write_text("// v2\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "other.cu").write_text("// a new source\n")
    assert cuda_build.library_path("k") != second
