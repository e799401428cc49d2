"""cdfo_tpu_torch ops and host code against their cdfo_tpu counterparts.

Inputs come from numpy seeds and go through both packages; float32
results agree within 1e-4 of the reference's largest magnitude (the JAX
suite's own rule), host numpy code exactly. The attention wrappers take
their plain versions on CPU tensors, so their launch counters stay 0
(except where a test stands in for the launch).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.infer import pipeline as jpipe
from cdfo_tpu.ops import fused_attention as jfa
from cdfo_tpu.ops import mv as jmv
from cdfo_tpu.ops import resize as jresize
from cdfo_tpu.ops import warp as jwarp
from cdfo_tpu_torch.infer import pipeline as tpipe
from cdfo_tpu_torch.ops import cuda_build
from cdfo_tpu_torch.ops import fused_attention as tfa
from cdfo_tpu_torch.ops import mv as tmv
from cdfo_tpu_torch.ops import resize as tresize
from cdfo_tpu_torch.ops import warp as twarp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close(port, ref, rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port.astype(np.float32) - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1.0), err


# -- host code ---------------------------------------------------------------

@pytest.mark.parametrize("center", [0, 1, 2, 4, 7, 8, 9])
def test_mv_expansion_and_edge_fixups(center):
    r = np.random.RandomState(center)
    mv = r.randint(-40, 40, (12, 20, 3)).astype(np.float32)
    mv[..., 2] = r.choice([-1.0, -2.0, 0.0], (12, 20))
    ours = tmv.mv2mvs(mv, 7)
    ref = jmv.mv2mvs(mv, 7)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        tmv.modify_mv_for_end_frames(center, ours.copy(), 10),
        jmv.modify_mv_for_end_frames(center, ref.copy(), 10))
    np.testing.assert_array_equal(tmv.generate_input_index(center, 7, 9),
                                  jmv.generate_input_index(center, 7, 9))
    flips = (bool(center & 1), bool(center & 2), bool(center & 4))
    field = r.randn(3, 6, 8, 2).astype(np.float32)
    np.testing.assert_array_equal(tmv.augment_mv(field, *flips),
                                  jmv.augment_mv(field, *flips))


def test_pipeline_host_parts():
    ours = tpipe.synthetic_sequence(t=5, h=18, w=22, seed=7)
    ref = jpipe.synthetic_sequence(t=5, h=18, w=22, seed=7)
    for f in ("lr", "pm", "rm", "uf", "mvl0", "mvl1"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert ours.num_frames == ref.num_frames == 5
    img = np.random.RandomState(0).rand(270, 32).astype(np.float32)
    np.testing.assert_array_equal(tpipe.pad_lr_frame(img),
                                  jpipe.pad_lr_frame(img))
    for rows in (1088, 736, 64):
        sr = np.zeros((rows, 8), np.uint8)
        assert (tpipe.crop_sr_output(sr).shape
                == jpipe.crop_sr_output(sr).shape)


# -- resize ------------------------------------------------------------------

@pytest.mark.parametrize("scale,size", [(0.5, None), (2.0, None),
                                        (4.0, None), (None, (11, 7))])
def test_interpolate_bilinear(scale, size):
    x = np.random.RandomState(1).randn(2, 10, 14, 3).astype(np.float32)
    ours = tresize.interpolate_bilinear(torch.from_numpy(x), scale, size)
    ref = jresize.interpolate_bilinear(jnp.asarray(x), scale, size)
    assert_close(ours, ref)


def test_pixel_shuffle():
    x = np.random.RandomState(2).randn(2, 5, 6, 12).astype(np.float32)
    np.testing.assert_array_equal(
        tresize.pixel_shuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jresize.pixel_shuffle(jnp.asarray(x), 2)))


# -- warp --------------------------------------------------------------------

def _flows(rng, b, h, w, blocky):
    if blocky:
        blk = rng.randn(b, h // 4, w // 4, 2).astype(np.float32) * 5
        fl = np.repeat(np.repeat(blk, 4, 1), 4, 2)
        fl[:, -2:] = 0.0  # zero-padded bottom rows (eval pipeline)
        return fl
    # large enough that many samples leave the frame (zeros padding and
    # the keep-mask)
    return rng.randn(b, h, w, 2).astype(np.float32) * 6


@pytest.mark.parametrize("blocky", [False, True])
def test_flow_warp(blocky):
    rng = np.random.RandomState(3)
    x = rng.rand(3, 16, 24, 8).astype(np.float32)
    fl = _flows(rng, 3, 16, 24, blocky)
    ours = twarp.flow_warp(torch.from_numpy(x), torch.from_numpy(fl))
    ref = jwarp.flow_warp(jnp.asarray(x), jnp.asarray(fl))
    assert_close(ours, ref)


@pytest.mark.parametrize("blocky", [False, True])
def test_flow_warp_ring_matches_quad_ring(blocky):
    """The port's unpacked ring against JAX's quad-packed ring warp."""
    rng = np.random.RandomState(4)
    frames = rng.rand(5, 16, 24, 8).astype(np.float32)
    fidx = np.array([0, 4, 1, 4, 2, 3], np.int32)
    fl = _flows(rng, 6, 16, 24, blocky)
    ours = twarp.flow_warp_ring(torch.from_numpy(frames),
                                torch.from_numpy(fidx), torch.from_numpy(fl))
    ref = jwarp.flow_warp_ring(jwarp.quad_pack(jnp.asarray(frames)),
                               jnp.asarray(fidx), jnp.asarray(fl))
    assert_close(ours, ref)


def test_flow_warp_bf16_flow_rounds_like_jax():
    """A bf16 model casts the flows to bf16 before the warp; coordinates
    are then formed in float32 from the rounded flow in both packages."""
    rng = np.random.RandomState(5)
    frames = rng.rand(2, 8, 16, 4).astype(np.float32)
    fl = rng.randn(2, 8, 16, 2).astype(np.float32) * 3
    fl_bf16 = torch.from_numpy(fl).to(torch.bfloat16)
    ours = twarp.flow_warp_ring(torch.from_numpy(frames),
                                torch.tensor([1, 0]), fl_bf16)
    ref = jwarp.flow_warp_ring(jwarp.quad_pack(jnp.asarray(frames)),
                               jnp.asarray([1, 0]),
                               jnp.asarray(fl).astype(jnp.bfloat16))
    assert_close(ours, ref)


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 27, 64), (2, 70, 16)])
def test_token_attention(shape):
    rng = np.random.RandomState(6)
    q = (rng.randn(*shape) * 0.4).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    ref = jfa._attn_reference(jnp.asarray(q), jnp.asarray(v))
    tfa.token_self_attention.launches = 0
    qt, vt = torch.from_numpy(q), torch.from_numpy(v)
    assert_close(tfa.token_attention_plain(qt, vt), ref)
    assert_close(tfa.token_self_attention(qt, vt), ref)
    assert tfa.token_self_attention.launches == 0


@pytest.mark.parametrize("shape", [(2, 17, 9, 64), (1, 8, 24, 16)])
def test_column_attention(shape):
    rng = np.random.RandomState(7)
    q = (rng.randn(*shape) * 0.4).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    ref = jfa._attn_cols_reference(jnp.asarray(q), jnp.asarray(v))
    tfa.column_self_attention.launches = 0
    qt, vt = torch.from_numpy(q), torch.from_numpy(v)
    assert_close(tfa.column_attention_plain(qt, vt), ref)
    out = tfa.column_self_attention(qt, vt)
    assert out.is_contiguous()
    assert_close(out, ref)
    assert tfa.column_self_attention.launches == 0


def test_attention_wrappers_refuse_other_devices():
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        tfa.token_self_attention(q, q)


@pytest.mark.parametrize("kind", ["token", "column"])
def test_attention_wrappers_refuse_grad_on_the_card(monkeypatch, kind):
    """The wrappers no longer refuse autograd on the card: each is an
    autograd Function whose forward launches the kernel (here a stand-in
    for the launch, which returns the plain result) and counts the launch,
    and whose backward is cdfo_tpu's ``_bwd`` / ``_col_bwd``: q's and v's
    gradients equal JAX's."""
    def launch(q, v, *args):
        return tfa.token_attention_plain(q, v) if kind == "token" else \
            tfa.column_attention_plain(q, v)

    monkeypatch.setattr(cuda_build, "on_card", lambda t, what: True)
    monkeypatch.setattr(tfa, "_launch", launch)
    fn, ref_fn = ((tfa.token_self_attention, jfa.token_self_attention)
                  if kind == "token" else
                  (tfa.column_self_attention, jfa.column_self_attention))
    # the stand-in's count is put back after the test, so that tests run
    # after it in the same process find the CPU route's counts
    monkeypatch.setattr(fn, "launches", fn.launches)
    shape = (2, 8, 64) if kind == "token" else (1, 8, 4, 64)
    r = np.random.RandomState(2)
    qn, vn, gn = ((r.randn(*shape) * s).astype(np.float32)
                  for s in (0.3, 1.0, 1.0))
    q = torch.from_numpy(qn).requires_grad_()
    v = torch.from_numpy(vn).requires_grad_()
    before = fn.launches
    out = fn(q, v)
    assert fn.launches == before + 1 and out.grad_fn is not None
    out.backward(torch.from_numpy(gn))
    _, vjp = jax.vjp(ref_fn, jnp.asarray(qn), jnp.asarray(vn))
    dq, dv = vjp(jnp.asarray(gn))
    assert_close(q.grad, dq)
    assert_close(v.grad, dv)


@pytest.mark.parametrize("kind", ["token", "column"])
def test_attention_plain_route_keeps_the_gradient(kind):
    """On the CPU the wrappers take the plain version, which the unfused
    EGLA trains through: q gets a non-zero gradient."""
    fn = (tfa.token_self_attention if kind == "token"
          else tfa.column_self_attention)
    shape = (2, 8, 16) if kind == "token" else (1, 8, 4, 16)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(shape, generator=g).requires_grad_()
    v = torch.randn(shape, generator=g)
    fn(q, v).square().sum().backward()
    assert q.grad is not None and q.grad.abs().max() > 0


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to the plain
    version."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME",
                        str(tmp_path / "no-cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_library("fused_attention")
    assert not (tmp_path / "build").exists()


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cdfo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cdfo_tpu_torch.__path__, 'cdfo_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cdfo_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
