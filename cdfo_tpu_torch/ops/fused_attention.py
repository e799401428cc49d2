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

The column wrapper reads (B, H, W, C) NHWC in place: a token is one (b, w)
column, its positions H rows of stride W*C. The TPU version transposes in
HBM first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library

HEAD_DIM = 64   # channels per position the kernel is compiled for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    lib = load_library("fused_attention")
    fn = lib.cdfo_fused_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cdfo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cdfo_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cdfo_cuda_error_string


def build():
    """Compile (if needed) and load the kernel library."""
    _kernel()


def _launch(q, v, n_tokens, n_inner, s_outer, s_inner, n, pos_stride):
    """Checks the operands and launches the kernel on the current stream:
    token t covers elements ``(t // n_inner) * s_outer + (t % n_inner) *
    s_inner + pos * pos_stride + c`` for pos < n, c < HEAD_DIM."""
    if v.device != q.device:
        raise ValueError(f"q on {q.device}, v on {v.device}")
    if q.dtype not in _DTYPES or v.dtype != q.dtype:
        raise TypeError(f"fused_attention takes float32 or bfloat16 q and v "
                        f"of one dtype, got {q.dtype} and {v.dtype}")
    if q.shape != v.shape or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"fused_attention needs q and v of one shape with "
                         f"{HEAD_DIM} channels, got {tuple(q.shape)} and "
                         f"{tuple(v.shape)}")
    if not (q.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention needs contiguous q and v")
    if q.numel() == 0:
        raise ValueError("fused_attention got an empty tensor")
    fn, err_str = _kernel()
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                 n_tokens, n_inner, s_outer, s_inner, n, pos_stride, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    return out


def _route(q: torch.Tensor) -> bool:
    """True: launch the kernel. False: CPU tensor, plain version."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise NotImplementedError(f"fused_attention has no path for {q.device}")


def token_self_attention(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[t] = softmax(q[t] q[t]^T) v[t]; q, v (T, N, C)."""
    if not _route(q):
        return token_attention_plain(q, v)
    t, n, c = q.shape
    out = _launch(q, v, t, 1, n * c, 0, n, c)
    token_self_attention.launches += 1
    return out


def column_self_attention(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[b, :, w] = softmax(q[b, :, w] q[b, :, w]^T) v[b, :, w];
    q, v (B, H, W, C)."""
    if not _route(q):
        return column_attention_plain(q, v)
    b, h, w, c = q.shape
    out = _launch(q, v, b * w, w, h * w * c, c, h, w * c)
    column_self_attention.launches += 1
    return out


token_self_attention.launches = 0
column_self_attention.launches = 0
