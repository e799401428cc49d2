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
