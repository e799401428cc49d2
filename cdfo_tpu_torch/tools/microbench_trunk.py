"""Micro-bench of the SCNet ``Block_`` body pair on the GPU, the port of
``tools/microbench_trunk.py``.

Candidates, all computing y = conv3x3_{256->64}(lrelu(conv3x3_{64->256}(x)
+ b1)) + b2 + x:
  plain_nhwc    two ``F.conv2d`` in channels_last (cuDNN), lrelu, residual
  plain_im2col  ``F.unfold`` of the 9 taps + one ``torch.matmul`` per conv
  kernel        the hand-written kernel (``ops/fused_block.block_body``),
                its weights packed once, as cuDNN's are laid out once

Weights from ``np.random.RandomState(0)`` with the TPU tool's scales. The
kernel is first held against its plain version
(``ops/fused_block.block_body_plain``, ``ops/kernel_cases.py``'s
tolerance); each line then gives ms per call (best of 20, CUDA events),
TF/s and the relative error against the first candidate. In float32
cuDNN's and cuBLAS's TF32 is switched off, so the error column measures
the kernels and not TF32.

    python -m cdfo_tpu_torch.tools.microbench_trunk [--h 272 --w 480 --b 1
        --dtype bfloat16 --which all]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fused_block as fb
from ..ops import kernel_cases as kc
from . import event_ms, require_card

CANDIDATES = ("plain_nhwc", "plain_im2col", "kernel")


def body_flops(b, h, w, cin=64, cmid=256):
    return 2 * b * h * w * 9 * (cin * cmid + cmid * cin)


def _oihw(w):
    return w.permute(3, 2, 0, 1).contiguous()


def candidates(x, w1, b1, w2, b2):
    """{name: fn() -> NHWC output} of the three candidates."""
    dt = x.dtype
    b, h, w, c = x.shape
    x_cl = x.permute(0, 3, 1, 2)            # NCHW view, channels_last memory
    k1, k2 = _oihw(w1), _oihw(w2)
    k1_cl = k1.contiguous(memory_format=torch.channels_last)
    k2_cl = k2.contiguous(memory_format=torch.channels_last)
    m1, m2 = k1.reshape(k1.shape[0], -1), k2.reshape(k2.shape[0], -1)
    packed = fb.pack_body_weights(w1, w2, dt)

    def plain_nhwc():
        y = F.leaky_relu(F.conv2d(x_cl, k1_cl, b1, padding=1), 0.1)
        y = F.conv2d(y, k2_cl, b2, padding=1)
        return (x_cl + y).permute(0, 2, 3, 1)

    def plain_im2col():
        def conv(t, mat, bias):   # t NCHW -> (B, cout, H*W), f32 sum + bias
            cols = F.unfold(t, 3, padding=1)           # (B, 9 cin, H*W)
            return torch.matmul(mat, cols).float() + bias.float()[:, None]
        y = F.leaky_relu(conv(x_cl, m1, b1), 0.1).to(dt).reshape(b, -1, h, w)
        out = conv(y, m2, b2).to(dt).reshape(b, c, h, w)
        return (x_cl + out).permute(0, 2, 3, 1)

    def kernel():
        return fb.block_body(x, w1, b1, w2, b2, residual=True, packed=packed)

    return {"plain_nhwc": plain_nhwc, "plain_im2col": plain_im2col,
            "kernel": kernel}


@torch.no_grad()
def main(argv=None) -> dict:
    """Prints one line per candidate; returns {name: (seconds, TF/s,
    relerr)}."""
    p = argparse.ArgumentParser()
    p.add_argument("--h", type=int, default=272)
    p.add_argument("--w", type=int, default=480)
    p.add_argument("--b", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--which", default="all", choices=["all", *CANDIDATES])
    args = p.parse_args(argv)
    card = require_card("microbench_trunk")
    dt = getattr(torch, args.dtype)
    if dt == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    r = np.random.RandomState(0)
    b, h, w = args.b, args.h, args.w

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)

    x = put(r.randn(b, h, w, 64))
    w1 = put(r.randn(3, 3, 64, 256) * 0.05)
    b1 = put(r.randn(256) * 0.05)
    w2 = put(r.randn(3, 3, 256, 64) * 0.02)
    b2 = put(r.randn(64) * 0.05)
    fl = body_flops(b, h, w)
    print(f"microbench_trunk ({b}, {h}, {w}, 64) {args.dtype} on {card}",
          flush=True)

    results, ref = {}, None
    for name, fn in candidates(x, w1, b1, w2, b2).items():
        if args.which not in ("all", name):
            continue
        if name == "kernel":
            kc.assert_outputs_close(
                fn(), fb.block_body_plain(x, w1, b1, w2, b2, residual=True),
                dt, "body")
        t = min(event_ms(fn, 20, warmup=3)) / 1e3
        out = fn().float()
        if ref is None:
            ref, err = out, 0.0
        else:
            err = float((out - ref).abs().max() / (ref.abs().max() + 1e-6))
        results[name] = (t, fl / t / 1e12, err)
        print(f"{name:12s} {t * 1e3:8.2f} ms   {fl / t / 1e12:6.1f} TF/s   "
              f"relerr {err:.2e}", flush=True)
    return results


if __name__ == "__main__":
    main()
