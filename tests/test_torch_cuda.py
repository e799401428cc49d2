"""The hand-written CUDA attention kernel against its plain PyTorch version,
on the card. A CUDA kernel has no interpret mode, so these tests skip where
no CUDA device exists. On a GPU machine (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from cdfo_tpu_torch.ops import fused_attention as fa

# relative to max |plain|; see chip_smoke.py for the reasoning
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", [
    ("token", (5, 64, 64)), ("token", (3, 130, 64)), ("token", (2, 1, 64)),
    ("column", (2, 70, 9, 64)), ("column", (1, 16, 24, 64))])
def test_kernel_matches_plain(cuda, dtype, kind, shape):
    kernel, plain = {
        "token": (fa.token_self_attention, fa.token_attention_plain),
        "column": (fa.column_self_attention, fa.column_attention_plain),
    }[kind]
    g = torch.Generator(device=cuda).manual_seed(1)
    q = (torch.randn(shape, generator=g, device=cuda) * 0.35).to(dtype)
    v = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = kernel.launches
    out = kernel(q, v)
    ref = plain(q, v)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOLERANCE[dtype] * ref.float().abs().max().item()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="64 channels"):
        fa.token_self_attention(q, q)
    q = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.token_self_attention(q, q)
    q = torch.zeros(8, 2, 64, device=cuda).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.token_self_attention(q, q)


# -- the fused-trunk kernels (Block_, group tail, head, alignment tail) ------

from cdfo_tpu_torch.ops import fused_block2 as fb  # noqa: E402
from cdfo_tpu_torch.ops import fused_groupconv as fg  # noqa: E402
from cdfo_tpu_torch.ops import fused_head as fh  # noqa: E402
from cdfo_tpu_torch.ops import fused_tail as ft  # noqa: E402


def _trunk_case(kind, shape, dtype, device, seed=2):
    """(wrapper, plain, args) for one fused-trunk kernel at NHWC ``shape``
    (the tail gets 3 neighbours per image of ``shape``)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=device) * scale).to(dtype)

    def rand(*s):
        return torch.rand(*s, generator=g, device=device).to(dtype)

    c = shape[-1]
    if kind == "block":
        return fb.scale_block, fb.scale_block_plain, (
            rnd(*shape), rnd(4 * c, c, 3, 3, scale=0.03), rnd(4 * c, scale=0.1),
            rnd(c, 4 * c, 3, 3, scale=0.02), rnd(c, scale=0.1),
            rnd(c, c, 1, 1, scale=0.1), rnd(c, scale=0.1),
            rnd(c, c, 1, 1, scale=0.1), rnd(c, scale=0.1))
    if kind == "group":
        return fg.grouptail, fg.grouptail_plain, (
            rnd(*shape), rnd(*shape), rnd(c, c, 3, 3, scale=0.05),
            rnd(c, scale=0.1))
    if kind == "head":
        return fh.fused_head, fh.fused_head_plain, (
            rnd(*shape), rand(*shape[:3], 1), rnd(4 * c, c, 1, 1, scale=0.1),
            rnd(4 * c, scale=0.1), rnd(4 * c, c, 1, 1, scale=0.1),
            rnd(4 * c, scale=0.1), rnd(1, c, 3, 3, scale=0.1),
            rnd(1, scale=0.1))
    ws = []
    for _ in range(4):
        ws += [rnd(c, c, 3, 3, scale=0.05), rnd(c, scale=0.1)]
    return ft.resblock_pair, ft.resblock_pair_plain, (
        rnd(3 * shape[0], *shape[1:]), rnd(*shape), rand(3 * shape[0], c),
        *ws)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 24, 64), (2, 18, 34, 64),
                                   (1, 10, 6, 64)])
@pytest.mark.parametrize("kind", ["block", "group", "head", "tail"])
def test_trunk_kernel_matches_plain(cuda, kind, shape, dtype):
    torch.backends.cudnn.allow_tf32 = False
    kernel, plain, args = _trunk_case(kind, shape, dtype, cuda)
    before = kernel.launches
    with torch.no_grad():
        out = kernel(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOLERANCE[dtype] * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["block", "group", "head", "tail"])
def test_trunk_kernel_rejects_what_it_does_not_take(cuda, kind):
    kernel, _, args = _trunk_case(kind, (1, 8, 8, 64), torch.float32, cuda)
    with torch.no_grad():
        narrow = _trunk_case(kind, (1, 8, 8, 32), torch.float32, cuda)[2]
        with pytest.raises(ValueError, match="64 channels"):
            kernel(*narrow)
        with pytest.raises(TypeError):
            kernel(*(a.half() for a in args))
        with pytest.raises(ValueError, match="contiguous"):
            kernel(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                   *args[1:])
        if kind == "block":
            odd = _trunk_case(kind, (1, 8, 7, 64), torch.float32, cuda)[2]
            with pytest.raises(ValueError, match="even"):
                kernel(*odd)
