"""The MDTA round of ``PartitionTransformerSA2`` as two passes over the
image (``cdfo_tpu/ops/fused_mdta.py``):

    x1 = x1 + attn(norm1(x1))          # channel attention over heads
    x1 = x1 + conv(norm2(x1)) + x2     # conv round + side injection

* ``mdta_stage1``: LN1, the qkv 1x1 (64 -> 192), the depthwise 3x3 and the
  statistics q^T k, q^T q, k^T k summed over the image (float32); returns
  v and the (3, C, C) statistics.
* ``attention_matrix``: the per-head softmax between the passes, on a few
  KB; plain PyTorch, as the JAX package leaves it to XLA.
* ``mdta_stage2``: t = x + proj(A v), then t + conv3x3(LN2 t) + b + x2.

``mdta_stage1_plain`` and ``mdta_stage2_plain`` are the plain PyTorch
versions. The wrappers ``mdta_stage1`` and ``mdta_stage2`` take them for a
CPU tensor; a CUDA tensor launches the hand-written kernels in
``csrc/fused_mdta.cu`` (the ports of the TPU kernels ``mdta_stage1`` and
``mdta_stage2``) or raises. Launches are counted in each wrapper's
``launches``; stage 1's call is two launches (the per-block partial sums,
then their fixed-order reduction) and counts once. ``pack_stage1_weights``
gives stage 1's weight operands (in bfloat16 the swizzled qkv, which the
kernel keeps resident in shared memory for ``wgmma``);
``mdta_stage1(..., packed=)`` takes them from a caller that keeps them
(``PartitionTransformerSA2Fast``); ``pack_stage2_weights`` and
``mdta_stage2(..., packed=)`` likewise for stage 2's projection and conv
(the attention matrices are per call).

Tensors are NHWC; weights are the torch layouts of ``MDTA.qkv``,
``.qkv_dwconv``, ``.project_out`` and ``PartitionTransformerSA2.conv``;
the norm parameters are float32. Both versions round where the TPU kernels
do: LN1(x) and qkv to the dtype, the depthwise 3x3 in float32 then q, k, v
to the dtype (the statistics are of the rounded q, k), A v to the dtype, t
to the dtype for the residual while LN2 reads the float32 t.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .fused_block2 import swizzle128

CHANNELS = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def _ln(xf, w, b):
    """Channel LayerNorm in float32 with the TPU kernel's E[x^2] - mu^2."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + 1e-5) * w.float() + b.float()


def _grams(q, k):
    """[q^T k, q^T q, k^T k] over pixels, float32: (M, 3, C, C)."""
    qf = q.float().flatten(1, 2)
    kf = k.float().flatten(1, 2)
    qt = qf.transpose(1, 2)
    return torch.stack([qt @ kf, qt @ qf, kf.transpose(1, 2) @ kf], dim=1)


def mdta_stage1_plain(x, ln_w, ln_b, w_qkv, w_dw):
    """x (M, H, W, C); ln_w, ln_b (C,) float32; w_qkv (3C, C, 1, 1); w_dw
    (3C, 1, 3, 3). Returns (v (M, H, W, C), stats (M, 3, C, C) float32)."""
    dt, c = x.dtype, x.shape[-1]
    y = _ln(x.float(), ln_w, ln_b).to(dt)
    qkv = torch.matmul(y.float(), w_qkv[:, :, 0, 0].float().t()).to(dt)
    dw = F.conv2d(qkv.float().permute(0, 3, 1, 2), w_dw.float(), padding=1,
                  groups=3 * c).permute(0, 2, 3, 1).to(dt)
    q, k, v = dw.split(c, dim=-1)
    return v.contiguous(), _grams(q, k)


def attention_matrix(stats, temperature, num_heads: int):
    """(B, 3, C, C) float32 statistics -> (B, C, C) block-diagonal channel
    attention: per head, softmax of the q k^T gram over the L2 norms of q
    and k times the head's temperature (``fused_mdta.attention_matrix``)."""
    b, _, c, _ = stats.shape
    ch = c // num_heads
    g = stats[:, 0]
    nq = stats[:, 1].diagonal(dim1=1, dim2=2).clamp_min(0.0).sqrt() \
        .clamp_min(1e-12)
    nk = stats[:, 2].diagonal(dim1=1, dim2=2).clamp_min(0.0).sqrt() \
        .clamp_min(1e-12)
    amat = stats.new_zeros(b, c, c)
    for hd in range(num_heads):
        sl = slice(hd * ch, (hd + 1) * ch)
        gb = g[:, sl, sl] / (nq[:, sl, None] * nk[:, None, sl])
        amat[:, sl, sl] = torch.softmax(
            gb * temperature[hd].reshape(1, 1, 1).float(), dim=-1)
    return amat


def mdta_stage2_plain(x, v, x2, amat, w_proj, ln_w, ln_b, w_conv, b_conv):
    """x, v, x2 (M, H, W, C); amat (M, C, C) in x's dtype; w_proj (C, C, 1,
    1); ln_w, ln_b (C,) float32; w_conv (C, C, 3, 3), b_conv (C,)."""
    dt = x.dtype
    o = torch.matmul(v.float(), amat.float().transpose(1, 2)[:, None]).to(dt)
    t = x.float() + torch.matmul(o.float(), w_proj[:, :, 0, 0].float().t())
    tl = _ln(t, ln_w, ln_b).to(dt)
    conv = F.conv2d(tl.float().permute(0, 3, 1, 2), w_conv.float(),
                    b_conv.float(), padding=1).permute(0, 2, 3, 1)
    return (conv + t.to(dt).float() + x2.float()).to(dt)


def pack_stage1_weights(w_qkv, w_dw, dtype):
    """Stage 1's (qkv weights, depthwise taps) operands: bfloat16 the qkv
    1x1 as the kernel keeps it resident, (3C n, C k), B[n][k] = w_qkv[n,
    k], 128-byte swizzled (``fused_block2.swizzle128``), and the taps
    float32 [9][3C] (tap 3dy + dx); float32 the qkv in
    ``cuda_build.kernel_weights``' layout and the taps [3C][9]. Callers may
    keep it."""
    taps = w_dw.float().reshape(w_dw.shape[0], 9)
    if dtype == torch.bfloat16:
        return swizzle128(w_qkv[:, :, 0, 0].to(dtype)), taps.t().contiguous()
    return cb.kernel_weights(w_qkv, dtype), taps.contiguous()


def pack_stage2_weights(w_proj, w_conv, dtype):
    """Stage 2's (projection, conv) operands: bfloat16 the 1x1 projection
    as B[n][k] = w_proj[n, k] and the 3x3 conv's 9 taps (3 ky + kx) as
    B[n][k] = w_conv[n, k, ky, kx], (C, C) and (9, C, C), 128-byte swizzled
    (``fused_block2.swizzle128``), which the kernel keeps resident; float32
    both in ``cuda_build.kernel_weights``' layout. Callers may keep it."""
    if dtype == torch.bfloat16:
        c = w_conv.shape[0]
        taps = w_conv.permute(2, 3, 0, 1).reshape(9, c, c)
        return (swizzle128(w_proj[:, :, 0, 0].to(dtype)),
                swizzle128(taps.to(dtype)))
    return cb.kernel_weights(w_proj, dtype), cb.kernel_weights(w_conv, dtype)


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    argtypes = {"cdfo_mdta_stage1_workspace": [_I] * 4,
                "cdfo_mdta_stage1": [_P] * 7 + [_I, _P] + [_I] * 4 + [_P],
                "cdfo_mdta_stage2": [_P] * 10 + [_I] * 4 + [_P]}[symbol]
    return cb.kernel_function("fused_mdta", symbol, argtypes)


def mdta_stage1(x, ln_w, ln_b, w_qkv, w_dw, packed=None):
    """(v, stats) of ``mdta_stage1_plain``; ``packed``:
    ``pack_stage1_weights`` of these weights in x's dtype, if the caller
    keeps it."""
    cb.forbid_grad("fused_mdta stage 1", x, ln_w, ln_b, w_qkv, w_dw)
    if not cb.on_card(x, "fused_mdta stage 1"):
        return mdta_stage1_plain(x, ln_w, ln_b, w_qkv, w_dw)
    what = "fused_mdta stage 1"
    cb.check_operands(what, x, w_qkv, w_dw, channels=CHANNELS)
    cb.check_float32(what, x.device, ln_w, ln_b)
    c = CHANNELS
    cb.check_shapes(what, {"ln_w": (ln_w, (c,)), "ln_b": (ln_b, (c,)),
                           "w_qkv": (w_qkv, (3 * c, c, 1, 1)),
                           "w_dw": (w_dw, (3 * c, 1, 3, 3))})
    m, h, wd, _ = x.shape
    v = torch.empty_like(x)
    stats = x.new_empty((m, 3, c, c), dtype=torch.float32)
    ws = cb.workspace(_kernel("cdfo_mdta_stage1_workspace"), what, x.device,
                      m, h, wd, cb.DTYPE_CODES[x.dtype])
    if packed is None:
        packed = pack_stage1_weights(w_qkv, w_dw, x.dtype)
    wk, taps = packed
    cb.launch(_kernel("cdfo_mdta_stage1"), what, x.device, x.data_ptr(),
              ln_w.data_ptr(), ln_b.data_ptr(), wk.data_ptr(),
              taps.data_ptr(), v.data_ptr(), ws.data_ptr(), ws.numel(),
              stats.data_ptr(), cb.DTYPE_CODES[x.dtype], m, h, wd)
    mdta_stage1.launches += 1
    return v, stats


def mdta_stage2(x, v, x2, amat, w_proj, ln_w, ln_b, w_conv, b_conv,
                packed=None):
    """``mdta_stage2_plain``: t + conv3x3(LN2 t) + b + x2 with t = x +
    proj(A v). ``packed``: ``pack_stage2_weights`` of these weights in x's
    dtype, if the caller keeps it."""
    args = (x, v, x2, amat, w_proj, ln_w, ln_b, w_conv, b_conv)
    what = "fused_mdta stage 2"
    cb.forbid_grad(what, *args)
    if not cb.on_card(x, what):
        return mdta_stage2_plain(*args)
    cb.check_operands(what, x, v, x2, amat, w_proj, w_conv, b_conv,
                      channels=CHANNELS)
    cb.check_float32(what, x.device, ln_w, ln_b)
    c = CHANNELS
    m, h, wd, _ = x.shape
    cb.check_shapes(what, {"v": (v, x.shape), "x2": (x2, x.shape),
                           "amat": (amat, (m, c, c)),
                           "w_proj": (w_proj, (c, c, 1, 1)),
                           "ln_w": (ln_w, (c,)), "ln_b": (ln_b, (c,)),
                           "w_conv": (w_conv, (c, c, 3, 3)),
                           "b_conv": (b_conv, (c,))})
    out = torch.empty_like(x)
    # bfloat16: the matrices as they are (the kernel swizzles each image's)
    ak = amat if x.dtype == torch.bfloat16 else cb.matrix_weights(amat, x.dtype)
    if packed is None:
        packed = pack_stage2_weights(w_proj, w_conv, x.dtype)
    pk, ck = packed
    cb.launch(_kernel("cdfo_mdta_stage2"), what, x.device, x.data_ptr(),
              v.data_ptr(), x2.data_ptr(), ak.data_ptr(), pk.data_ptr(),
              ln_w.data_ptr(), ln_b.data_ptr(), ck.data_ptr(),
              b_conv.data_ptr(), out.data_ptr(), cb.DTYPE_CODES[x.dtype], m,
              h, wd)
    mdta_stage2.launches += 1
    return out


mdta_stage1.launches = 0
mdta_stage2.launches = 0
