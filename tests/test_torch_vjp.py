"""The backwards of the four kernels the port trains through against
cdfo_tpu's, on the CPU: ``ops/fused_attention``'s row and column
Functions against ``jax.vjp`` of ``token_self_attention`` /
``column_self_attention`` (their custom ``_bwd`` / ``_col_bwd``), and
``ops/fused_vjp``'s ``block_fused``, ``grouptail_fused`` and ``head_fused``
against ``jax.vjp`` of ``_block_twin``, ``_grouptail_twin`` and
``_head_twin`` (what JAX's ``_block_bwd`` and its siblings return), on the
same inputs and cotangent from numpy seeds.

Every input's and weight's gradient agrees within 1e-4 of the reference's
largest magnitude in float32 (the JAX suite's rule). In bfloat16 it is
held against JAX's bfloat16 gradient within the port's bfloat16 tolerance
(``kernel_cases.TOLERANCE``, 1.6e-2 of the largest magnitude) plus the
rounding error JAX's bfloat16 gradient itself carries (its largest
distance from JAX's float32 gradient on the same inputs): a backward
chains several bfloat16-rounded products and sums, and both sides' errors
against float32 reach ~1e-1 of the largest magnitude (a bias gradient
summed over every pixel, the head's input), each its own. The trunk's plain versions take any
channel count, so the ``Block_`` and the tail run narrow. Also: the kept
weight packs are remade after an in-place Adam step, and are built
without a graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.ops import fused_attention as jfa
from cdfo_tpu.ops import fused_vjp as jvjp
from cdfo_tpu_torch.ops import cuda_build as cb
from cdfo_tpu_torch.ops import fused_attention as tfa
from cdfo_tpu_torch.ops import fused_vjp as tvjp
from cdfo_tpu_torch.ops.kernel_cases import TOLERANCE

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def assert_close(port, ref, dtype, what, ref32=None):
    """max |port - ref| <= tolerance x max |ref|, plus, for a bfloat16
    ``ref``, its own distance from the float32 gradient ``ref32``."""
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    slack = 0.0 if ref32 is None else np.abs(ref - ref32).max()
    assert err <= TOLERANCE[dtype] * np.abs(ref).max() + slack, (
        what, err, np.abs(ref).max(), slack)


def hcw(a):
    """NHWC -> the JAX twins' row-major (B, H, C, W)."""
    return np.ascontiguousarray(np.transpose(a, (0, 1, 3, 2)))


def t_conv(k):
    """HWIO -> torch (out, in, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def port_grads(fn, arrays, torch_dtype, cotangent, needs):
    """fn(*tensors) with the tensors of ``needs`` requiring grad; returns
    their gradients for the cotangent."""
    ts = [torch.from_numpy(a).to(torch_dtype).requires_grad_(n)
          for a, n in zip(arrays, needs)]
    out = fn(*ts)
    out.backward(torch.from_numpy(cotangent).to(out.dtype))
    return [t.grad for t, n in zip(ts, needs) if n]


_FLOAT32_GRADS = {}


def jax_grads(fn, arrays, jax_dtype, cotangent, needs):
    """JAX's gradients in ``jax_dtype`` and, for bfloat16, in float32 (the
    slack of ``assert_close``; kept from the float32 case of the same
    inputs), as float32 numpy arrays."""
    def grads(dt):
        xs = [jnp.asarray(a, dt) for a in arrays]
        ct = jnp.asarray(cotangent, jax.eval_shape(fn, *xs).dtype)
        gs = jax.jit(lambda c, *x: jax.vjp(fn, *x)[1](c))(ct, *xs)
        return [np.asarray(jnp.asarray(g, jnp.float32))
                for g, n in zip(gs, needs) if n]

    key = (fn, tuple(a.tobytes() for a in arrays), cotangent.tobytes())
    if key not in _FLOAT32_GRADS:
        _FLOAT32_GRADS[key] = grads(jnp.float32)
    if jax_dtype == jnp.float32:
        return [(g, None) for g in _FLOAT32_GRADS[key]]
    return list(zip(grads(jax_dtype), _FLOAT32_GRADS[key]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,shape", [("token", (6, 24, 64)),
                                        ("token", (3, 17, 64)),
                                        ("column", (2, 16, 12, 64)),
                                        ("column", (1, 9, 5, 64))])
def test_attention_backward_matches_cdfo_tpu(kind, shape, dtype):
    tdt, jdt = DTYPES[dtype]
    r = np.random.RandomState(1)
    q = (r.randn(*shape) * 0.3).astype(np.float32)
    v = r.randn(*shape).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    port, ref = {"token": (tfa.token_self_attention, jfa.token_self_attention),
                 "column": (tfa.column_self_attention,
                            jfa.column_self_attention)}[kind]
    dq, dv = port_grads(port, (q, v), tdt, g, (True, True))
    (jq, jq32), (jv, jv32) = jax_grads(ref, (q, v), jdt, g, (True, True))
    assert dq.dtype == tdt and dv.dtype == tdt
    assert_close(dq, jq, tdt, "dq", jq32)
    assert_close(dv, jv, tdt, "dv", jv32)
    assert tfa.token_self_attention.launches == 0
    assert tfa.column_self_attention.launches == 0


def _block_case(seed, c):
    r = np.random.RandomState(seed)

    def k(kh, cin, cout, scale):
        return (r.randn(kh, kh, cin, cout) * scale).astype(np.float32)

    def b(n):
        return (r.randn(n) * 0.1).astype(np.float32)

    x = r.randn(1, 6, 8, c).astype(np.float32)
    ws = [k(3, c, 4 * c, 0.1), b(4 * c), k(3, 4 * c, c, 0.05), b(c),
          k(1, c, c, 0.2), b(c), k(1, c, c, 0.2), b(c)]
    return x, ws, r.randn(*x.shape).astype(np.float32)


def _head_case(seed, c):
    r = np.random.RandomState(seed)
    t = r.randn(2, 5, 6, c).astype(np.float32)
    lr = r.rand(2, 5, 6, 1).astype(np.float32)
    ws = [(r.randn(1, 1, c, 4 * c) * 0.2).astype(np.float32),
          (r.randn(4 * c) * 0.1).astype(np.float32),
          (r.randn(1, 1, c, 4 * c) * 0.2).astype(np.float32),
          (r.randn(4 * c) * 0.1).astype(np.float32),
          (r.randn(3, 3, c, 1) * 0.1).astype(np.float32),
          (r.randn(1) * 0.1).astype(np.float32)]
    return t, lr, ws, r.randn(2, 20, 24, 1).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["block", "group", "head"])
def test_trunk_backward_matches_cdfo_tpu(kind, dtype):
    """block_fused / grouptail_fused / head_fused: every input's and
    weight's gradient against the JAX twin's vjp. The head's LR centre
    frame takes no gradient (it is model input)."""
    tdt, jdt = DTYPES[dtype]
    c = 8
    if kind == "block":
        x, ws, g = _block_case(3, c)
        args = [(x, "x")] + [(w, "w" if w.ndim == 4 else "v") for w in ws]
        port, ref = tvjp.block_fused, jvjp._block_twin
    elif kind == "group":
        r = np.random.RandomState(4)
        x, skip, g = (r.randn(2, 7, 9, c).astype(np.float32)
                      for _ in range(3))
        kg = (r.randn(3, 3, c, c) * 0.1).astype(np.float32)
        bg = (r.randn(c) * 0.1).astype(np.float32)
        args = [(x, "x"), (skip, "x"), (kg, "w"), (bg, "v")]
        port, ref = tvjp.grouptail_fused, jvjp._grouptail_twin
    else:
        t, lr, ws, g = _head_case(5, c)
        args = [(t, "x"), (lr, "v")] + [(w, "w" if w.ndim == 4 else "v")
                                        for w in ws]
        port, ref = tvjp.head_fused, jvjp._head_twin
    # per argument: "x" an NHWC activation (JAX: HCW), "w" a conv weight
    # (JAX: HWIO), "v" as it is; the head's output is NHWC on both sides
    to_jax = {"x": hcw, "w": lambda a: a, "v": lambda a: a}
    to_port = {"x": lambda a: a, "w": t_conv, "v": lambda a: a}
    back = {"x": lambda a: np.transpose(a, (0, 1, 3, 2)),
            "w": lambda a: np.transpose(a, (3, 2, 0, 1)),
            "v": lambda a: a}
    needs = tuple(not (kind == "head" and i == 1) for i in range(len(args)))
    got = port_grads(port, [to_port[k](a) for a, k in args], tdt, g, needs)
    want = jax_grads(ref, [to_jax[k](a) for a, k in args], jdt,
                     g if kind == "head" else hcw(g), needs)
    kinds = [k for (_, k), n in zip(args, needs) if n]
    for i, (a, (b, b32), k) in enumerate(zip(got, want, kinds)):
        assert a.dtype == tdt, (i, a.dtype)
        assert_close(a, back[k](b), tdt, f"{kind} grad {i}",
                     None if b32 is None else back[k](b32))


def test_group_skip_gradient_is_the_cotangent():
    """grouptail's skip enters as a plain add: its gradient is g itself."""
    r = np.random.RandomState(6)
    x, skip, g = (torch.from_numpy(r.randn(1, 4, 6, 8).astype(np.float32))
                  for _ in range(3))
    skip.requires_grad_()
    w = torch.from_numpy((r.randn(8, 8, 3, 3) * 0.1).astype(np.float32))
    tvjp.grouptail_fused(x, skip, w, torch.zeros(8)).backward(g)
    assert torch.equal(skip.grad, g)


class _Owner:
    pass


def test_pack_is_remade_after_an_inplace_adam_step(monkeypatch):
    """``cached_pack`` keys on the parameters' versions: an in-place Adam
    step bumps them, so the next call packs anew; the pack is built
    without autograd, so it holds no graph. (On the CPU the real call
    returns None, so the device test is patched.)"""
    w = torch.nn.Parameter(torch.randn(8, 8, 3, 3))
    opt = torch.optim.Adam([w], lr=1e-3)
    x = torch.zeros(1, 2, 2, 8)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    owner, packs = _Owner(), []

    def pack(dtype):
        packs.append(w * 2.0)
        return packs[-1]

    first = cb.cached_pack(owner, "_pack", x, (w,), pack)
    assert first.grad_fn is None and not first.requires_grad
    assert cb.cached_pack(owner, "_pack", x, (w,), pack) is first
    (w * w).sum().backward()
    opt.step()
    second = cb.cached_pack(owner, "_pack", x, (w,), pack)
    assert second is not first and len(packs) == 2
    torch.testing.assert_close(second, w.detach() * 2.0)
