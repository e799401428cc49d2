"""The port's ``Block_`` body pair (``cdfo_tpu_torch/ops/fused_block.py``)
against the JAX package's fused kernel ``fused_block_body`` (run in
interpret mode on the CPU), on the same numpy-seeded inputs: residual on
and off, at an (H, W) that is a multiple of neither the TPU kernel's rows
nor its W tile. float32 within 1e-4 of the largest value; bfloat16 (both
sides round y and the output to bfloat16) per image at the kernels'
bfloat16 tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdfo_tpu.ops.fused_block import fused_block_body
from cdfo_tpu_torch.ops import fused_block as fbody
from cdfo_tpu_torch.ops import kernel_cases as kc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (1, 12, 40, 64)   # rows 8, wt 128: a ragged row step and W tile


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    b, h, w, c = SHAPE
    return (r.randn(b, h, w, c), r.randn(3, 3, c, 4 * c) * 0.05,
            r.randn(4 * c) * 0.05, r.randn(3, 3, 4 * c, c) * 0.02,
            r.randn(c) * 0.05)


@pytest.mark.parametrize("dtype,residual", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True),
    (torch.bfloat16, False)])
def test_body_matches_jax_kernel(dtype, residual):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    args = [np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
            for a in _inputs()]
    ref = fused_block_body(*(jnp.asarray(a, jdt) for a in args), rows=8,
                           wt=128, residual=residual)
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32))).to(dtype)
    targs = [torch.from_numpy(a).to(dtype) for a in args]
    before = fbody.block_body.launches
    out = fbody.block_body(*targs, residual=residual)
    assert fbody.block_body.launches == before   # CPU: the plain version
    kc.assert_outputs_close(out, ref, dtype, "body")
    kc.assert_outputs_close(fbody.block_body_plain(*targs, residual=residual),
                            ref, dtype, "body")


def test_body_refuses_grad():
    args = [torch.from_numpy(a).float() for a in _inputs()]
    args[1].requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        fbody.block_body(*args)
