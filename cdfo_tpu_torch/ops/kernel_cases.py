"""Seeded inputs for the kernel wrappers, and the rule by which a kernel's
output is held against its plain version's. ``chip_smoke.py`` and the
port's tests draw their cases and limits here.

A kernel agrees with its plain version when, on every output and on every
slice of it whose entries share one scale, max |kernel - plain| is at most
``tolerance(dtype, kind)`` times max |plain| over that slice. A slice is the
whole output unless ``SCALE_DIMS`` splits it: the statistics of the MDTA
and dual-MSA passes are held per image and per gram (a q^T q diagonal is
~100x the q^T k entries that set the attention), their GAP sums per image
and per input, their feature maps per image, as are EGLA's q_c, v_r and
output, the int8 ``Block_``'s output and the block warp's.

``excite_egla_mask`` sets the weights of a model so that its EGLA residual
mask is one-hot in every frame (under seeded random weights no channel's
probability reaches the 0.5 threshold, and an all-zero mask zeroes the
composed q projection of the fused EGLA). ``zoo_model`` builds a registry
model so for the card checks, its zero-initialised weights (the deformable
offset heads) refilled; ``admitted_flags`` lists the kernel flags a CVSR_V8
ablation's config takes.
"""
from __future__ import annotations

import numpy as np
import torch

from .probe_dma import mk_starts

# relative to max |plain| of the slice: float32 differs only in summation
# order; bfloat16 rounds intermediates and the output to 8 mantissa bits
# (one output ulp is 2^-8 of the largest value), at other points than
# eager PyTorch, so 4 ulps
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
# the int8 Block_ (``blockq``): kernel and plain version take the same
# int8 products, exact in int32, so they part only where a float32 sum
# taken in another order (a window's sum of squares, the 0.5x branch) moves
# a value across a rounding boundary: a few activations one quantization
# step apart. float32: 5e-3, a tenth of what cdfo_tpu's own test allows
# between the int8 and the exact kernel (rel < 0.05); bfloat16 keeps the
# 4 output ulps of every bfloat16 kernel, since one ulp of the output type
# is already 4e-3 to 8e-3 of the largest value.
KIND_TOLERANCE = {"blockq": {torch.float32: 5e-3, torch.bfloat16: 1.6e-2},
                  # the DMA probe's checksum: float32 sums of the same
                  # bfloat16 values in another order (float32's limit); its
                  # big copy returns copied values, exactly
                  "gather": {torch.bfloat16: 1e-4},
                  "big": {torch.bfloat16: 0.0}}
# and its outputs correlate with the plain version's at least this much
# (cdfo_tpu asks 0.999 between int8 and exact)
BLOCKQ_MIN_CORRELATION = 0.9999

# per output of the wrapper: how many leading dimensions index slices of
# one scale (0: the whole output)
SCALE_DIMS = {"mdta1": (1, 2), "mdta2": (1,), "msa1": (2, 2), "msa2": (1, 1),
              "eg1": (1, 1), "eg2": (1,), "blockq": (1,), "warp": (1,),
              "warp_blocky": (1,), "warp_mixed": (1,), "warp_arbitrary": (1,),
              "body": (1,)}
WARP_CASES = ("blocky", "mixed", "arbitrary")


def tolerance(dtype: torch.dtype, kind: str | None = None) -> float:
    """The limit on max |kernel - plain| / max |plain| of a slice."""
    return KIND_TOLERANCE.get(kind, TOLERANCE)[dtype]


def worst_error(out, ref, kind: str | None = None) -> tuple[float, float]:
    """(max |kernel - plain|, max |plain|) over the slice (of the outputs
    ``out`` and ``ref``, each a tensor or a tuple of them, cut as
    ``SCALE_DIMS[kind]`` says) whose error is largest against its scale."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    lead = SCALE_DIMS.get(kind, (0,) * len(outs))
    worst, worst_ratio = (0.0, 0.0), -1.0
    for o, r, n in zip(outs, refs, lead, strict=True):
        err = (o.float() - r.float()).abs().flatten(n).amax(dim=-1).flatten()
        scale = r.float().abs().flatten(n).amax(dim=-1).flatten()
        ratio = err / scale.clamp_min(1e-30)
        i = int(ratio.argmax())
        if ratio[i].item() > worst_ratio:
            worst, worst_ratio = (err[i].item(), scale[i].item()), ratio[i].item()
    return worst


def max_abs_error(out, ref) -> float:
    """max |kernel - plain| over every output."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    return max((o.float() - r.float()).abs().max().item()
               for o, r in zip(outs, refs, strict=True))


def assert_outputs_close(out, ref, dtype: torch.dtype,
                         kind: str | None = None) -> None:
    """Each output of a wrapper of the same dtype and shape as the plain
    version's, and every slice within ``tolerance(dtype, kind)`` (the
    float32 statistics of a bfloat16 run too: they sum rounded values)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.dtype == r.dtype and o.shape == r.shape, (o.shape, r.shape)
    err, scale = worst_error(out, ref, kind)
    assert err <= tolerance(dtype, kind) * scale, (kind, err, scale)
    if kind == "blockq":
        corr = torch.corrcoef(torch.stack([outs[0].float().flatten(),
                                           refs[0].float().flatten()]))[0, 1]
        assert corr >= BLOCKQ_MIN_CORRELATION, (kind, float(corr))


def trunk_args(kind: str, dtype: torch.dtype, g: torch.Generator, shape,
               nbr: int = 3, device="cuda") -> tuple:
    """Inputs of one fused-trunk kernel (``block``, ``group``, ``head`` or
    ``tail``) at NHWC ``shape``, drawn from ``g`` on ``device``; the tail
    gets ``nbr`` neighbour images per image of ``shape``."""
    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=device) * scale).to(dtype)

    def rand(*s):
        return torch.rand(*s, generator=g, device=device).to(dtype)

    c = shape[-1]
    if kind in ("block", "blockq"):
        return (rnd(*shape), rnd(4 * c, c, 3, 3, scale=0.03),
                rnd(4 * c, scale=0.1), rnd(c, 4 * c, 3, 3, scale=0.02),
                rnd(c, scale=0.1), rnd(c, c, 1, 1, scale=0.1),
                rnd(c, scale=0.1), rnd(c, c, 1, 1, scale=0.1),
                rnd(c, scale=0.1))
    if kind == "group":
        return (rnd(*shape), rnd(*shape), rnd(c, c, 3, 3, scale=0.05),
                rnd(c, scale=0.1))
    if kind == "head":
        return (rnd(*shape), rand(*shape[:3], 1),
                rnd(4 * c, c, 1, 1, scale=0.1), rnd(4 * c, scale=0.1),
                rnd(4 * c, c, 1, 1, scale=0.1), rnd(4 * c, scale=0.1),
                rnd(1, c, 3, 3, scale=0.1), rnd(1, scale=0.1))
    ws = []
    for _ in range(4):
        ws += [rnd(c, c, 3, 3, scale=0.05), rnd(c, scale=0.1)]
    return (rnd(nbr * shape[0], *shape[1:]), rnd(*shape),
            rand(nbr * shape[0], c), *ws)


def attention_args(dtype: torch.dtype, g: torch.Generator, shape,
                   device="cuda") -> tuple:
    """(q, v) of the attention kernel at ``shape`` ((T, N, C) tokens or
    (B, H, W, C) columns), drawn from ``g`` on ``device``; q at 0.35 so that
    the softmax rows are neither flat nor one-hot."""
    q = (torch.randn(shape, generator=g, device=device) * 0.35).to(dtype)
    return q, torch.randn(shape, generator=g, device=device).to(dtype)


def warp_args(case: str, dtype: torch.dtype, g: torch.Generator, shape,
              device="cuda") -> tuple:
    """(ring, frame_idx, flow) of the block warp for ``shape`` (L ring
    slots, B images, H, W), drawn from ``g`` on ``device``. ``blocky``:
    flows constant over 4x4 blocks, with a block fully outside the frame,
    a partly valid corner block and a partly valid bottom block;
    ``mixed``: those with the bottom 2 rows zeroed (the eval pipeline's
    row padding) and single pixels of some blocks moved; ``arbitrary``: a
    flow of its own per pixel."""
    l, b, h, w = shape
    ring = torch.rand(l, h, w, 64, generator=g, device=device).to(dtype)
    frame_idx = torch.randint(0, l, (b,), generator=g, device=device)
    if case == "arbitrary":
        flow = torch.randn(b, h, w, 2, generator=g, device=device) * 2.0
        return ring, frame_idx, flow.to(dtype)
    blk = torch.randn(b, h // 4, w // 4, 2, generator=g, device=device) * 3.0
    blk[0, 0, 0, 0], blk[0, 0, 0, 1] = -50.0, 2.0
    blk[0, 0, 1] = -1.5
    blk[-1, -1, -1, 0], blk[-1, -1, -1, 1] = 2.5, h - 1.25
    flow = blk.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    if case == "mixed":
        flow[:, h - 2:] = 0.0
        flow[:, 5::16, 6::12, 0] += 1.0
    return ring, frame_idx, flow.to(dtype)


def align_embed_args(kind: str, dtype: torch.dtype, g: torch.Generator,
                     shape, nbr: int, device="cuda") -> tuple:
    """Inputs of one MDTA or dual-MSA pass (``mdta1``, ``mdta2``, ``msa1``
    or ``msa2``), drawn from ``g`` on ``device``: ``shape`` (M, H, W) the
    MDTA images, or the centres of ``nbr`` neighbours each; the norm
    parameters are float32 and the attention matrices softmax rows (the
    MSA's scaled by gates)."""
    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=device) * scale).to(dtype)

    def f32(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, generator=g, device=device) * scale + shift

    def attn(b, gated):
        a = torch.softmax(f32(b, 64, 64) * 2.0, dim=-1)
        if gated:
            a = a * torch.rand(b, 1, 64, generator=g, device=device)
        return a.to(dtype)

    c = 64
    m, h, w = shape
    if kind == "mdta1":
        return (rnd(m, h, w, c), f32(c, scale=0.1, shift=1.0),
                f32(c, scale=0.1), rnd(3 * c, c, 1, 1, scale=0.12),
                rnd(3 * c, 1, 3, 3, scale=0.3))
    if kind == "mdta2":
        return (rnd(m, h, w, c), rnd(m, h, w, c), rnd(m, h, w, c),
                attn(m, False), rnd(c, c, 1, 1, scale=0.12),
                f32(c, scale=0.1, shift=1.0), f32(c, scale=0.1),
                rnd(c, c, 3, 3, scale=0.04), rnd(c, scale=0.1))
    b = m * nbr
    nb = (rnd(b, h, w, c), rnd(b, h, w, c), rnd(m, h, w, c))
    wf = rnd(c, 2 * c, 1, 1, scale=0.09)
    if kind == "msa1":
        return (*nb, wf)
    return (*nb, attn(b, True).transpose(1, 2).contiguous(),
            attn(b, True).transpose(1, 2).contiguous(),
            rnd(c, c, 1, 1, scale=0.12), wf)


def egla_args(kind: str, dtype: torch.dtype, g: torch.Generator, shape,
              device="cuda") -> tuple:
    """Inputs of ``eg1_rows`` (``eg1``) or ``eg2_local_fuse`` (``eg2``) at
    NHWC ``shape``, drawn from ``g`` on ``device``: a general full-rank
    per-frame q projection (a real one-hot mask makes it rank one), a random
    0/1 inverse mask, nonzero biases and H-band taps (h9 float32), and a
    long-range input of the scale of v."""
    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=device) * scale).to(dtype)

    m, c = shape[0], shape[-1]
    if kind == "eg1":
        return (rnd(*shape), rnd(m, c, c, scale=0.04), rnd(m, c, scale=0.1),
                rnd(c, c, scale=0.125), rnd(1, c, scale=0.1),
                torch.randn(10, generator=g, device=device) * 0.3)
    mask_inv = (torch.rand(m, c, generator=g, device=device) < 0.5).to(dtype)
    return (rnd(*shape), rnd(*shape), rnd(c, c, scale=0.04),
            rnd(1, c, scale=0.1), rnd(c, c, scale=0.125), rnd(1, c, scale=0.1),
            mask_inv, rnd(c, c, scale=0.1), rnd(c, c, scale=0.1),
            rnd(1, c, scale=0.1))


def body_args(dtype: torch.dtype, g: torch.Generator, shape,
              device="cuda") -> tuple:
    """(x, w1, b1, w2, b2) of the ``Block_`` body pair at NHWC ``shape``,
    HWIO weights, with the trunk microbenchmark's scales."""
    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=device) * scale).to(dtype)

    c = shape[-1]
    return (rnd(*shape), rnd(3, 3, c, 4 * c, scale=0.05),
            rnd(4 * c, scale=0.05), rnd(3, 3, 4 * c, c, scale=0.02),
            rnd(c, scale=0.05))


def dots_args(g: torch.Generator, m: int, k: int, n: int, nplanes: int = 4,
              device="cuda") -> tuple:
    """(lhs (m, k), rhs (nplanes, k, n)) bfloat16 of the dot probe, with the
    tool's scale."""
    def rnd(*s):
        return (torch.randn(*s, generator=g, device=device) * 0.1).bfloat16()

    return rnd(m, k), rnd(nplanes, k, n)


def rows_args(g: torch.Generator, m: int, c: int, n: int, nrows: int = 8,
              device="cuda") -> tuple:
    """(w (m, 9c) bf16, b (m, 1) float32, cm (1, n) float32, u (nrows + 2,
    c, n + 8) bf16) of the row probes: the tool's scales, and a column mask
    with about one zero in eight (the tool's is all ones) so that a kernel
    that drops the mask fails."""
    def rnd(*s):
        return (torch.randn(*s, generator=g, device=device) * 0.1).bfloat16()

    cm = (torch.rand(1, n, generator=g, device=device) >= 0.125).float()
    return rnd(m, 9 * c), rnd(m, 1).float(), cm, rnd(nrows + 2, c, n + 8)


def dma_args(rng: np.random.RandomState, h: int, w: int, c: int, nblk: int,
             pw: int, device="cuda") -> tuple:
    """(ring (h + 8, (w + 8) c) bf16, starts (2 nblk,) int32) of the DMA
    probe, drawn from ``rng`` as the tool draws them."""
    ring = torch.from_numpy(rng.randn(h + 8, (w + 8) * c).astype(np.float32))
    starts = torch.from_numpy(mk_starts(rng, h, w, c, nblk, pw))
    return ring.bfloat16().to(device), starts.to(device)


@torch.no_grad()
def excite_egla_mask(model, channel: int = 3) -> None:
    """Adds 10 to one channel's bias of ``model.RDAB.conv_du_re2[0]`` (a
    ``CVSRV8``): that channel's softmax probability then passes 0.5 in
    every frame, so the mask is one-hot."""
    model.RDAB.conv_du_re2[0].bias[channel] += 10.0


# the CVSR_V8 ablations: the registry's five and the model without EGLA
ABLATIONS = {"woPAB": dict(use_pab=False), "woLA": dict(use_la=False),
             "woGA": dict(use_ga=False), "woMV": dict(use_mv=False),
             "woPd": dict(use_pd=False), "noEGLA": dict(use_egla=False)}
KERNEL_FLAGS = ("fused_trunk", "fused_embed", "fused_align", "fused_egla",
                "block_warp")


def admitted_flags(ablation: dict) -> dict:
    """Every kernel flag of ``KERNEL_FLAGS`` that a ``ModelConfig`` with
    the ``ablation``'s fields takes, added in order (``fused_align`` after
    ``fused_trunk``, which it needs)."""
    from ..config import ModelConfig
    flags = {}
    for f in KERNEL_FLAGS:
        try:
            ModelConfig(**ablation, **flags, **{f: True})
        except ValueError:
            continue
        flags[f] = True
    return flags


@torch.no_grad()
def zoo_model(cfg, device="cuda"):
    """The registry's model for ``cfg`` with the seeded weights
    (``torch.Generator().manual_seed(0)``), the EGLA mask one-hot where the
    model has the full EGLA, and every all-zero weight of more than one
    entry (the deformable offset and mask heads, the norms' biases)
    refilled with seeded values of std 0.05, so that a deformable conv's
    offsets are more than its flow."""
    from ..models import build_model
    from ..models.attention import EGLA
    model = build_model(cfg.name, cfg, torch.Generator().manual_seed(0),
                        device=device)
    if isinstance(getattr(model, "RDAB", None), EGLA):
        excite_egla_mask(model)
    g = torch.Generator().manual_seed(1)
    for p in model.parameters():
        if p.numel() > 1 and not p.any():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model
