"""The port's trunk probes (``cdfo_tpu_torch/ops/probe_dots.py``,
``probe_dma.py``) against the TPU probes' kernels in ``tools/`` on the same
numpy-seeded inputs. The tools are loaded by file path and each kernel is
wrapped in ``pl.pallas_call(..., interpret=True)`` exactly as its tool
builds it. On CPU tensors the port's wrappers take their plain versions.
The dot probes give bfloat16 outputs, held at the kernels' bfloat16
tolerance; the DMA checksums are sums of the same values (float32 limit)
or copies (exact)."""
import functools
import importlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cdfo_tpu_torch.ops import kernel_cases as kc
from cdfo_tpu_torch.ops import probe_dma as pm
from cdfo_tpu_torch.ops import probe_dots as pd


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's spinning thread pools in each of them
    oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
# m, k, c of 16-32 and a ragged n; kstack needs reps > nrows
M, K, C, N, NROWS = 16, 32, 16, 132, 4


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dots():
    return _tool("microbench_dots")


@pytest.fixture(scope="module")
def dma():
    return _tool("microbench_dma")


def _bf16(a):
    """numpy -> (jax bf16, torch bf16) of the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


def _close(out, ref, kind=None):
    kc.assert_outputs_close(out, torch.from_numpy(np.asarray(
        ref.astype(jnp.float32))).to(out.dtype), torch.bfloat16, kind)


@pytest.mark.parametrize("reps", [1, 6])
def test_dot_case_matches_tpu_kernel(dots, reps):
    r = np.random.RandomState(0)
    (lj, lt), (rj, rt) = _bf16(r.randn(M, K) * 0.1), _bf16(
        r.randn(4, K, N) * 0.1)
    fn = pl.pallas_call(
        functools.partial(dots._kernel, reps=reps, nplanes=4),
        in_specs=[VMEM] * 2, out_specs=VMEM,
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((M, N), jnp.float32)], interpret=True)
    before = pd.dot_case.launches
    _close(pd.dot_case(lt, rt, reps), fn(lj, rj))
    assert pd.dot_case.launches == before


def _rows_inputs(r, b_bf16: bool):
    w = _bf16(r.randn(M, 9 * C) * 0.1)
    b = r.randn(M, 1) * 0.1
    b = np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32)) \
        if b_bf16 else b.astype(np.float32)
    cm = (r.rand(1, N) >= 0.125).astype(np.float32)
    u = _bf16(r.randn(NROWS + 2, C, N + 8) * 0.1)
    return w, b, cm, u


@pytest.mark.parametrize("kind", ["rowpipe", "kstack"])
def test_row_probes_match_tpu_kernels(dots, kind):
    reps = 2 * NROWS + 1
    (wj, wt), b, cm, (uj, ut) = _rows_inputs(np.random.RandomState(1),
                                             kind == "rowpipe")
    if kind == "rowpipe":
        kern = functools.partial(dots._rowpipe_kernel, reps=reps, nrows=NROWS,
                                 m=M, c3=3 * C, n=N)
        scratch = [pltpu.VMEM((NROWS, M, N), jnp.bfloat16)]
    else:
        kern = functools.partial(dots._kstack_kernel, reps=reps, nrows=NROWS,
                                 m=M, c=C, n=N)
        scratch = [pltpu.VMEM((NROWS + 2, 3, C, N + 2), jnp.bfloat16),
                   pltpu.VMEM((NROWS, M, N), jnp.bfloat16)]
    fn = pl.pallas_call(kern, in_specs=[VMEM] * 4, out_specs=VMEM,
                        out_shape=jax.ShapeDtypeStruct((M, N), jnp.bfloat16),
                        scratch_shapes=scratch, interpret=True)
    ref = fn(wj, jnp.asarray(b), jnp.asarray(cm), uj)
    wrapper = pd.rowpipe if kind == "rowpipe" else pd.kstack
    before = wrapper.launches
    _close(wrapper(wt, torch.from_numpy(b), torch.from_numpy(cm), ut, reps,
                   NROWS), ref)
    assert wrapper.launches == before


def test_kstack_refuses_reps_up_to_nrows():
    g = torch.Generator().manual_seed(0)
    w, b, cm, u = kc.rows_args(g, M, C, N, NROWS, device="cpu")
    with pytest.raises(ValueError, match="reps > nrows"):
        pd.kstack(w, b, cm, u, NROWS, NROWS)
    pd.rowpipe(w, b, cm, u, 1, NROWS)


@pytest.mark.parametrize("mode", ["patch", "row", "big"])
def test_dma_probe_matches_tpu_kernels(dma, mode):
    h, w, c, nblk = 16, 24, 32, 10
    rng = np.random.RandomState(0)
    ring = rng.randn(h + 8, (w + 8) * c).astype(np.float32)
    ring_j, ring_t = _bf16(ring)
    if mode == "big":
        rows = pm.big_rows(h, w, nblk)
        starts = pm.mk_starts(rng, h, w, c, nblk, 6)
        starts[0] = h + 8 - rows + 3   # past the ring: clamped, as on the TPU
        kern = functools.partial(dma._big_kernel, rows=rows, c=c)
        scratch = [pltpu.VMEM((rows, (w + 8) * c), jnp.bfloat16),
                   pltpu.SemaphoreType.DMA(())]
    else:
        ph, pw = pm.PATCHES[mode]
        starts = pm.mk_starts(rng, h, w, c, nblk, pw)
        starts[2] = h + 8 - ph + 5   # past the ring: clamped, as on the TPU
        starts[5] = (w + 8) * c      # likewise
        kern = functools.partial(dma._gather_kernel, nblk=nblk, ph=ph, pw=pw,
                                 c=c, mode=mode)
        scratch = [pltpu.VMEM((dma.NSLOTS, ph, pw * c), jnp.bfloat16),
                   pltpu.SemaphoreType.DMA((dma.NSLOTS,))]
    call = pl.pallas_call(
        kern, grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
            out_specs=VMEM, scratch_shapes=scratch),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.float32), interpret=True)
    ref = torch.from_numpy(np.asarray(call(jnp.asarray(starts), ring_j)))
    st = torch.from_numpy(starts)
    wrapper = pm.big if mode == "big" else pm.gather
    before = wrapper.launches
    out = (pm.big(ring_t, st, rows) if mode == "big"
           else pm.gather(ring_t, st, ph, pw * c))
    assert wrapper.launches == before
    kc.assert_outputs_close(out, ref, torch.bfloat16,
                            "big" if mode == "big" else "gather")


@pytest.mark.parametrize("tool", ["microbench_trunk", "microbench_dots",
                                  "microbench_dma", "compare_block"])
def test_tools_raise_without_a_card(monkeypatch, tool):
    """The port's tools measure the kernels on the card and have no CPU
    mode: without CUDA they raise before doing any work."""
    mod = importlib.import_module(f"cdfo_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CPU mode"):
        mod.main([])


def test_compare_block_loads_another_checkout():
    """``tools/compare_block`` imports another checkout's kernel modules
    (``--kernel block|blockq|tail``) as a package of its own (here this
    checkout's): modules apart from the port's, whose CPU route and weight
    packs are this checkout's."""
    from cdfo_tpu_torch.ops import fused_block2 as fb
    from cdfo_tpu_torch.tools import compare_block

    root = pathlib.Path(__file__).resolve().parents[1]
    for module, *_ in compare_block.KERNELS.values():
        name = module.__name__.split(".")[-1]
        other = compare_block.other_module(root, name)
        assert other is not module and other.__name__ == (
            f"cdfo_tpu_torch_other.ops.{name}")
    other = compare_block.other_module(root, "fused_block2")
    g = torch.Generator().manual_seed(3)
    x, *params = kc.trunk_args("block", torch.float32, g, (1, 6, 8, 64),
                               device="cpu")
    assert torch.equal(other.scale_block(x, *params),
                       fb.scale_block_plain(x, *params))
    for dtype in (torch.float32, torch.bfloat16):
        for a, b in zip(other.pack_weights(*params, dtype),
                        fb.pack_weights(*params, dtype)):
            assert (a is None and b is None) or torch.equal(a, b)
