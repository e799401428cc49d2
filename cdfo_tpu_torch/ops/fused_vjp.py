"""The fused trunk's kernels as ``torch.autograd.Function``s, the port of
``cdfo_tpu/ops/fused_vjp.py``: what ``ModelConfig(fused_trunk=True)``
trains through.

* **forward**: the wrapper (``fused_block2.scale_block``,
  ``fused_groupconv.grouptail``, ``fused_head.fused_head``), with the
  caller's kept weight pack: the hand-written kernel on a CUDA tensor, the
  plain version on a CPU one.
* **backward**: recomputes through the plain version (``scale_block_plain``,
  ``grouptail_plain``, ``fused_head_plain``, the NHWC forms of JAX's
  ``_block_twin``, ``_grouptail_twin``, ``_head_twin``) under
  ``enable_grad`` and returns ``torch.autograd.grad`` of it, as JAX's
  ``_block_bwd`` returns ``jax.vjp(_block_twin)``. The forward saves only
  its inputs: the 2x branch's activations are remade, not kept.

The backward launches no kernel: it runs on cuDNN and ATen on the card, as
JAX's runs on XLA. The kernels and the plain versions compute one function
(within rounding), so the gradients are those of the forward.
"""
from __future__ import annotations

import torch

from .fused_block2 import scale_block, scale_block_plain
from .fused_groupconv import grouptail, grouptail_plain
from .fused_head import fused_head, fused_head_plain


def _recompute_grad(ctx, plain, g):
    """The gradients of ``plain(*saved inputs)`` for the cotangent g, for
    the inputs ``ctx.needs_input_grad`` asks for (None for the others)."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*inputs)
        wanted = [t for t, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, wd, bd, wu, bu, packed):
        ctx.save_for_backward(x, w1, b1, w2, b2, wd, bd, wu, bu)
        return scale_block(x, w1, b1, w2, b2, wd, bd, wu, bu, packed=packed)

    @staticmethod
    def backward(ctx, g):
        return (*_recompute_grad(ctx, scale_block_plain, g), None)


class _GroupTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skip, w, b, packed):
        ctx.save_for_backward(x, skip, w, b)
        return grouptail(x, skip, w, b, packed=packed)

    @staticmethod
    def backward(ctx, g):
        return (*_recompute_grad(ctx, grouptail_plain, g), None)


class _Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, lr, w1, b1, w2, b2, wl, bl, packed):
        ctx.save_for_backward(t, lr, w1, b1, w2, b2, wl, bl)
        return fused_head(t, lr, w1, b1, w2, b2, wl, bl, packed=packed)

    @staticmethod
    def backward(ctx, g):
        return (*_recompute_grad(ctx, fused_head_plain, g), None)


def block_fused(x, w1, b1, w2, b2, wd, bd, wu, bu, packed=None):
    """``fused_block2.scale_block`` with the recompute backward of JAX's
    ``block_fused``; NHWC x, torch-layout weights; ``packed``: the
    weights' kept pack (built without a graph: ``cuda_build.cached_pack``)."""
    return _Block.apply(x, w1, b1, w2, b2, wd, bd, wu, bu, packed)


def grouptail_fused(x, skip, w, b, packed=None):
    """``fused_groupconv.grouptail`` (skip + conv3x3(x) + b) with the
    recompute backward of JAX's ``grouptail_fused``."""
    return _GroupTail.apply(x, skip, w, b, packed)


def head_fused(t, lr, w1, b1, w2, b2, wl, bl, packed=None):
    """``fused_head.fused_head`` (the upsample head and the bilinear x4
    base, float32 out) with the recompute backward of JAX's
    ``head_fused``."""
    return _Head.apply(t, lr, w1, b1, w2, b2, wl, bl, packed)
