"""Per-token self-attention for EGLA's 1-D long-range stages.

``out[t] = softmax(q[t] q[t]^T) v[t]``: no 1/sqrt(d) scale, scores and
softmax in float32, the probabilities rounded to the input dtype before the
product with v (``cdfo_tpu/ops/fused_attention.py``).

* ``token_attention_plain`` / ``column_attention_plain``: plain PyTorch
  versions of ``_attn_reference`` / ``_attn_cols_reference``. They
  materialise the (T, N, N) float32 scores.
* ``token_self_attention`` / ``column_self_attention``: the wrappers the
  model calls. A CPU tensor takes the plain version. A CUDA tensor launches
  the hand-written kernel in ``csrc/fused_attention.cu`` (the port of the
  TPU kernel ``_pallas_forward``), which never writes the scores, or
  raises: there is no fallback. Each wrapper counts its kernel launches in
  its ``launches`` attribute.

The kernel is inference-only: on a CUDA tensor under autograd a wrapper
raises ``NotImplementedError`` (the launch would return a result without a
``grad_fn``). The CPU plain version stays differentiable, since the unfused
``EGLA.forward`` trains through it, so the check comes after the device
test.

The column wrapper reads (B, H, W, C) NHWC in place: a token is one (b, w)
column, its positions H rows of stride W*C. The TPU version transposes in
HBM first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build as cb

HEAD_DIM = 64   # channels per position the kernel is compiled for


def token_attention_plain(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, v (T, N, C) -> (T, N, C) in v's dtype."""
    qf = q.float()
    p = torch.softmax(torch.matmul(qf, qf.transpose(1, 2)), dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def column_attention_plain(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, v (B, H, W, C); attention along H for every (b, w) column."""
    qt = q.float().permute(0, 2, 1, 3)                    # b w h c
    p = torch.softmax(torch.matmul(qt, qt.transpose(-1, -2)), dim=-1)
    out = torch.matmul(p.to(v.dtype), v.permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function(
        "fused_attention", "cdfo_fused_attention",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_longlong] * 4
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])


def _launch(q, v, n_tokens, n_inner, s_outer, s_inner, n, pos_stride):
    """Checks the operands and launches the kernel on the current stream:
    token t covers elements ``(t // n_inner) * s_outer + (t % n_inner) *
    s_inner + pos * pos_stride + c`` for pos < n, c < HEAD_DIM."""
    cb.check_operands("fused_attention", q, v, channels=HEAD_DIM)
    if q.shape != v.shape:
        raise ValueError(f"fused_attention needs q and v of one shape, got "
                         f"{tuple(q.shape)} and {tuple(v.shape)}")
    out = torch.empty_like(v)
    cb.launch(_kernel(), "fused_attention", q.device, q.data_ptr(),
              v.data_ptr(), out.data_ptr(), cb.DTYPE_CODES[q.dtype],
              n_tokens, n_inner, s_outer, s_inner, n, pos_stride)
    return out


def token_self_attention(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[t] = softmax(q[t] q[t]^T) v[t]; q, v (T, N, C)."""
    if not cb.on_card(q, "fused_attention"):
        return token_attention_plain(q, v)
    cb.forbid_grad("fused_attention", q, v)
    t, n, c = q.shape
    out = _launch(q, v, t, 1, n * c, 0, n, c)
    token_self_attention.launches += 1
    return out


def column_self_attention(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[b, :, w] = softmax(q[b, :, w] q[b, :, w]^T) v[b, :, w];
    q, v (B, H, W, C)."""
    if not cb.on_card(q, "fused_attention"):
        return column_attention_plain(q, v)
    cb.forbid_grad("fused_attention", q, v)
    b, h, w, c = q.shape
    out = _launch(q, v, b * w, w, h * w * c, c, h, w * c)
    column_self_attention.launches += 1
    return out


token_self_attention.launches = 0
column_self_attention.launches = 0
