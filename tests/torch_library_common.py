"""Helpers of the ``tests/test_torch_library_*.py`` files, which hold the
port's library modules (those no registry model builds) against
``cdfo_tpu``'s in float32 on the CPU.

A module's JAX params come from its own ``init``, jitted unless an
argument is static (a swin block's ``x_size``). Every all-zero
leaf is refilled with seeded values before the port loads the tree: the
deformable offset and mask heads, the DCN biases, ``PAM``'s and the other
attention blocks' ``gamma``; a zero there would let a wrong layout pass.
The port loads ``from_flax``'s ``state_dict`` strictly, so a leaf that it
does not map, maps twice or maps to the wrong shape fails the test.
"""
import jax
import numpy as np
import torch

from cdfo_tpu_torch.compat import from_flax


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def uniform_draw(shape, seed=5):
    """A uniform draw in [tiny, 1), as the gumbel samplers take it."""
    return np.maximum(np.random.RandomState(seed).rand(*shape),
                      np.finfo(np.float32).tiny).astype(np.float32)


def assert_close(port, ref, rel=1e-4, what=""):
    """Equal within ``rel`` of the reference's largest value."""
    port = (port.detach().float().numpy() if isinstance(port, torch.Tensor)
            else np.asarray(port, np.float32))
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(ref).all(), what
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def refill_zeros(tree, seed=1):
    """Every all-zero leaf refilled: arrays with values of std 0.05, a
    single value (a ``gamma``, a 9-tap bias) uniform in [0.5, 1)."""
    r = np.random.RandomState(seed)

    def fill(x):
        x = np.array(x)
        if not x.any():
            x = (r.randn(*x.shape) * 0.05 if x.size > 1
                 else r.uniform(0.5, 1.0, x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(fill, tree)


def jax_params(module, *args, seed=0, jit=True):
    """``module``'s params from its init on ``args``, zeros refilled."""
    init = jax.jit(module.init) if jit else module.init
    params = init(jax.random.PRNGKey(seed), *args)
    return refill_zeros(jax.tree.map(np.array, params))


def load(port, params):
    """``port`` with ``from_flax(params)`` loaded strictly; returns it."""
    port.load_state_dict(from_flax(params), strict=True)
    return port.eval()


def t_(*arrays):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrays)


def run(port, *args, **kw):
    with torch.no_grad():
        return port(*t_(*args), **kw)
