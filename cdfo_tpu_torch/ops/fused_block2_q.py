"""The int8 SCNet ``Block_`` (``cdfo_tpu/ops/fused_block2_q.py``): the
``Block_`` of ``ops/fused_block2.py`` with conv1 at 1x and 2x, conv2 at 1x
and the down2-folded conv2 computed as int8 x int8 -> int32 products.

The quantization scheme, which is what the TPU kernel and this port share:

* weights symmetric int8 per output channel, ``s = max(amax, 1e-8) / 127``
  (``quant_weight``); the 0.5x branch uses the same int8 weights,
  dequantised and rounded to bfloat16, so one set of weights ships;
* the image is walked in steps of ``rows x cols`` pixels: the steps of one
  column strip run serially from the top row down, the strips and images
  are independent;
* per step, the masked 1x input window ``xm`` is quantized with its own
  amax, and the 2x planes ``u = up2(z)`` with the amax of ``z = ku x + bu``
  over the window (``u`` is a convex blend of ``z``);
* the lrelu'd conv1 outputs ``y1`` (1x) and ``y2`` (2x) use a lagged
  running scale: step ``i`` quantizes with ``LAG_MARGIN`` times the largest
  amax measured in the steps ``< i`` of its strip, and step 0 starts from
  ``min(rowsum|W1| * amax(in), 5 * rownorm2(W1) * rms(in)) + max|b1|``;
  larger values clip to +-127;
* int32 sums are dequantised by ``s_act * s_w[channel]`` before bias and
  activation; the 1x1 convs, the 0.5x branch, the resizes and the residual
  stay in the working type with float32 accumulation.

The result therefore depends on the step geometry, which
``scale_block_q_plain`` takes as an argument (``StepGeometry``): with
``tpu_geometry`` it computes what ``scale_block_hcw_q`` computes, with
``KERNEL_GEOMETRY`` what ``csrc/fused_block2_q.cu`` computes. The port's
int8 ``Block_`` is the scheme at ``KERNEL_GEOMETRY`` on every device:

* ``scale_block_q``: the wrapper the int8 trunk calls. A CPU tensor takes
  the plain version, a CUDA tensor launches the kernel or raises. Launches
  are counted in ``scale_block_q.launches`` (one per call; in bfloat16 a
  call is two launches of the kernel's library: the 0.5x branch, then the
  walk down the strips); ``clip_counts=True`` also returns how many ``y1``
  and ``y2`` values clipped.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from .fused_block2 import CHANNELS, fold_down_conv2, pointers, swizzle128
from .resize import interpolate_bilinear

# headroom on the lagged y1/y2 scales: modest growth from one step to the
# next quantizes finely instead of clipping
LAG_MARGIN = 1.25
_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class StepGeometry:
    """How the int8 ``Block_`` walks an image. ``rows`` x ``cols``: the
    pixels of one step (both even). The amax windows of a step at (r0, c0)
    are its halo'd windows: ``xm`` rows r0-2 .. r0+rows+1, columns c0-2 ..
    c0+cols+1; ``z`` the same with ``z_extra`` more columns on the right;
    ``y1`` rows r0-1 .. r0+rows, columns c0-1 .. c0+cols; ``y2`` the 2x
    rows 2r0-1 .. 2r0+2rows and columns 2c0-1 .. 2c0+2cols with ``y2_extra``
    more on each side. Outside the image x repeats its edge for ``edge``
    pixels and is zero beyond (None: it repeats without end), which only
    the ``z`` statistics see."""

    rows: int
    cols: int
    z_extra: int = 0
    y2_extra: int = 0
    edge: int | None = None


# csrc/fused_block2_q.cu: 8 x 8 steps down 8-pixel column strips
KERNEL_GEOMETRY = StepGeometry(8, 8)


def tpu_geometry(w: int, rows: int = 16, wt: int | None = None) -> StepGeometry:
    """The steps of ``scale_block_hcw_q`` as ``cdfo_tpu``'s trunk calls it
    on a ``w``-wide image: 16 rows by one lane tile (the whole 128-padded
    width up to 1024 lanes, equal 128-aligned tiles beyond), z one column
    wider, y2 one 2x column wider each side, x edge-padded by 6."""
    if wt is None:
        wp = -(-w // 128) * 128
        ntiles = -(-wp // 1024)
        wt = -(-wp // (ntiles * 128)) * 128
    return StepGeometry(rows, wt, z_extra=1, y2_extra=1, edge=6)


def quant_weight(w: torch.Tensor):
    """(M, ...) -> (int8 of w's shape, float32 scales (M, 1)): symmetric,
    per output channel."""
    wf = w.float().reshape(w.shape[0], -1)
    s = wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q.reshape(w.shape), s


def quantize_block(w1, b1, w2, dtype):
    """The int8 side of one block's weights, from torch-layout conv1 /
    conv2 weights in the working type: (w1q, s1, w2q, s2, wfq, sf, bnd, w1b,
    w2b) with w?q int8 in torch layout (wfq the down2-folded conv2, (C, 4C,
    4, 4)), s? float32 (out,), bnd float32 (3,) = (max row sum of
    |dequantised W1|, max |b1|, max row 2-norm of it) and w1b / w2b the
    dequantised weights rounded to bfloat16, in ``dtype``."""
    w1q, s1 = quant_weight(w1.to(dtype))
    w2q, s2 = quant_weight(w2.to(dtype))
    wfq, sf = quant_weight(fold_down_conv2(w2.to(dtype)).to(dtype))
    w1f = w1q.float().reshape(w1q.shape[0], -1) * s1
    bnd = torch.stack([w1f.abs().sum(dim=1).max(), b1.float().abs().max(),
                       (w1f * w1f).sum(dim=1).max().sqrt()])
    w1b = w1f.reshape(w1q.shape).to(torch.bfloat16).to(dtype)
    w2b = (w2q.float() * s2.reshape(-1, 1, 1, 1)).to(torch.bfloat16).to(dtype)
    return (w1q, s1.reshape(-1), w2q, s2.reshape(-1), wfq, sf.reshape(-1),
            bnd, w1b, w2b)


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1):
    """Valid convolution of int8-valued float32 ``xq`` (N, K, h, w) with
    int8 ``wq`` (M, K, kh, kw): the exact int32 sums, as float32 (rounded
    to nearest as an int32 -> float32 conversion is). The input channels
    are cut into groups whose partial sums stay below 2^24, where float32
    adds integers exactly in any order."""
    m, k, kh, kw = wq.shape
    gc = max(d for d in range(1, k + 1)
             if k % d == 0 and d * kh * kw * 127 * 127 < 2 ** 24)
    g = k // gc
    wg = wq.float().reshape(m, g, gc, kh, kw).transpose(0, 1) \
        .reshape(g * m, gc, kh, kw)
    if xq.device.type == "cuda":
        with torch.backends.cudnn.flags(allow_tf32=False):
            y = F.conv2d(xq, wg, stride=stride, groups=g)
    else:
        y = F.conv2d(xq, wg, stride=stride, groups=g)
    n, _, oh, ow = y.shape
    return y.reshape(n, g, m, oh, ow).to(torch.int32).sum(dim=1).float()


def _quant(t: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """round(t * inv) before clipping (float32, integer-valued)."""
    return torch.round(t * inv)


def _lrelu(t):
    return torch.where(t >= 0, t, 0.1 * t)


def scale_block_q_plain(x, w1, b1, w2, b2, wd, bd, wu, bu,
                        geometry: StepGeometry = KERNEL_GEOMETRY,
                        clip_counts: bool = False):
    """The int8 ``Block_`` by plain tensor operations. x (B, H, W, C), H
    and W even; torch-layout weights as ``scale_block_plain``. Float parts
    are computed in float32 and rounded to x's dtype where the kernels
    round (z, the 0.5x branch's d, y5, conv2 sum and e, the folded sum
    before kd). With ``clip_counts`` also returns float64 (2,): how many
    values of y1 and of y2 clipped, each element counted once (in the
    step that owns its pixel)."""
    geo = geometry
    dt = x.dtype
    bsz, h, w, c = x.shape
    cm = w1.shape[0]
    dev = x.device
    r_, cw, zx, e2 = geo.rows, geo.cols, geo.z_extra, geo.y2_extra

    def rd(t):
        return t.to(dt).float()

    w1q, s1, w2q, s2, wfq, sf, bnd, w1b, w2b = quantize_block(w1, b1, w2, dt)
    rs1, b1max, rn1 = bnd[0], bnd[1], bnd[2]
    b1f, b2f = b1.float().reshape(1, -1, 1, 1), b2.float().reshape(1, -1, 1, 1)
    nr, nc = -(-h // r_), -(-w // cw)
    hp, wp = nr * r_, nc * cw

    # canvases: index = image coordinate + 2 (1x), 2x coordinate + 2 (+ e2)
    rr = torch.arange(-2, hp + 2, device=dev)
    cc = torch.arange(-2, wp + 2 + zx, device=dev)
    xe = x.float()[:, rr.clamp(0, h - 1)][:, :, cc.clamp(0, w - 1)]
    if geo.edge is not None:
        near = (((rr >= -geo.edge) & (rr < h + geo.edge))[:, None]
                & ((cc >= -geo.edge) & (cc < w + geo.edge))[None, :])
        xe = xe * near[None, :, :, None]
    in1 = (((rr >= 0) & (rr < h))[:, None]
           & ((cc >= 0) & (cc < w))[None, :]).float()
    xm = xe * in1[None, :, :, None]
    zf = xe @ wu.float()[:, :, 0, 0].t() + bu.float()
    z = rd(zf)[:, :, :wp + 4]
    # u = up2(z): H blend, then W blend (2x rows and columns -2 .. 2hp+1,
    # 2wp+1), zero outside the 2x image
    he = 0.25 * z[:, 0:hp + 2] + 0.75 * z[:, 1:hp + 3]
    ho = 0.75 * z[:, 1:hp + 3] + 0.25 * z[:, 2:hp + 4]
    hr = torch.stack([he, ho], dim=2).reshape(bsz, 2 * hp + 4, wp + 4, c)
    ue = 0.25 * hr[:, :, 0:wp + 2] + 0.75 * hr[:, :, 1:wp + 3]
    uo = 0.75 * hr[:, :, 1:wp + 3] + 0.25 * hr[:, :, 2:wp + 4]
    u = torch.stack([ue, uo], dim=3).reshape(bsz, 2 * hp + 4, 2 * wp + 4, c)
    q2r = torch.arange(-2, 2 * hp + 2, device=dev)
    q2c = torch.arange(-2, 2 * wp + 2, device=dev)
    in2 = (((q2r >= 0) & (q2r < 2 * h))[:, None]
           & ((q2c >= 0) & (q2c < 2 * w))[None, :]).float()
    u = F.pad(u * in2[None, :, :, None], (0, 0, e2, e2))
    in2 = F.pad(in2, (e2, e2))

    def win(t, r_lo, rows, c_lo, width, step):
        """Windows of canvas t (B, Hc, Wc, C) or mask (Hc, Wc): rows r_lo
        .. r_lo+rows-1, one window per strip starting at column c_lo +
        strip * step: (B * nc, C, rows, width) or (1, nc, 1, rows, width)."""
        if t.dim() == 2:
            v = t[r_lo:r_lo + rows, c_lo:].unfold(1, width, step)[:, :nc]
            return v.permute(1, 0, 2)[None, :, None]
        v = t[:, r_lo:r_lo + rows, c_lo:].unfold(2, width, step)[:, :, :nc]
        return v.permute(0, 2, 3, 1, 4).reshape(bsz * nc, c, rows, width)

    def per_window(t):   # (B * nc, ...) -> amax, sum of squares (B * nc,)
        f = t.reshape(bsz * nc, -1)
        return f.abs().amax(dim=1), (f * f).sum(dim=1)

    def col(s):   # per-window scalars against (B * nc, C, rows, width)
        return s.reshape(-1, 1, 1, 1)

    def scale_of(amax):
        s = amax.clamp_min(1e-8) / 127.0
        return s, 1.0 / s

    def masked(m):   # (1, nc, 1, rows, width) mask for (B * nc, C', ...)
        return m.expand(bsz, -1, -1, -1, -1).reshape(bsz * nc, 1,
                                                     *m.shape[-2:])

    run1 = torch.zeros(bsz * nc, device=dev)
    run2 = torch.zeros(bsz * nc, device=dev)
    clipped = torch.zeros(2, dtype=torch.float64, device=dev)
    canvas = torch.empty(bsz, hp, wp, c, device=dev)
    for i in range(nr):
        r0 = i * r_
        xw = win(xm, r0, r_ + 4, 0, cw + 4, cw)
        m1 = masked(win(in1, r0, r_ + 4, 0, cw + 4, cw))
        x_max, x_ssq = per_window(xw)
        x_cnt = (m1.reshape(bsz * nc, -1).sum(dim=1) * c).clamp_min(1.0)
        x_rms = torch.sqrt(x_ssq / x_cnt)
        s_xm, inv_xm = scale_of(x_max)
        xq = _quant(xw, col(inv_xm)).clamp(-127, 127)
        z_max, z_ssq = per_window(win(zf, r0, r_ + 4, 0, cw + 4 + zx, cw))
        z_rms = torch.sqrt(z_ssq / ((r_ + 4) * c * (cw + 4 + zx)))
        s_u, inv_u = scale_of(z_max)
        uq = _quant(win(u, 2 * r0, 2 * r_ + 4, 0, 2 * cw + 4 + 2 * e2,
                        2 * cw), col(inv_u)).clamp(-127, 127)

        def boot(in_max, in_rms):
            return torch.minimum(rs1 * in_max, 5.0 * rn1 * in_rms) + b1max

        base2 = boot(z_max, z_rms) if i == 0 else LAG_MARGIN * run2
        base1 = boot(x_max, x_rms) if i == 0 else LAG_MARGIN * run1
        s_y2, inv_y2 = scale_of(base2)
        s_y1, inv_y1 = scale_of(base1)

        # conv1 at 2x
        m2 = masked(win(in2, 2 * r0 + 1, 2 * r_ + 2, 1,
                        2 * cw + 2 + 2 * e2, 2 * cw))
        y2 = _lrelu(_int_conv(uq, w1q) * (s1.reshape(1, -1, 1, 1) * col(s_u))
                    + b1f) * m2
        run2 = torch.maximum(run2, per_window(y2)[0])
        y2r = _quant(y2, col(inv_y2))
        y2r = y2r[..., e2:y2r.shape[-1] - e2]
        # conv1 at 1x
        my = masked(win(in1, r0 + 1, r_ + 2, 1, cw + 2, cw))
        y1 = _lrelu(_int_conv(xq, w1q) * (s1.reshape(1, -1, 1, 1) * col(s_xm))
                    + b1f) * my
        run1 = torch.maximum(run1, per_window(y1)[0])
        y1r = _quant(y1, col(inv_y1))
        if clip_counts:
            clipped[0] += (y1r[..., 1:-1, 1:-1].abs() > 127).sum()
            clipped[1] += (y2r[..., 1:-1, 1:-1].abs() > 127).sum()
        body = _int_conv(y1r.clamp(-127, 127), w2q) \
            * (s2.reshape(1, -1, 1, 1) * col(s_y1)) + b2f
        fold = rd(_int_conv(y2r.clamp(-127, 127), wfq, stride=2)
                  * (sf.reshape(1, -1, 1, 1) * col(s_y2)) + b2f)
        upres = torch.einsum("nchw,oc->nohw", fold, wd.float()[:, :, 0, 0]) \
            + bd.float().reshape(1, -1, 1, 1)
        tile = (body + upres).reshape(bsz, nc, c, r_, cw)
        canvas[:, r0:r0 + r_] = tile.permute(0, 3, 1, 4, 2) \
            .reshape(bsz, r_, wp, c)

    # the 0.5x branch, with the dequantised weights
    def conv(t, wt, b, pad):
        y = F.conv2d(t.permute(0, 3, 1, 2), wt.float(), b.float(),
                     padding=pad)
        return y.permute(0, 2, 3, 1)

    d = rd(conv(rd(interpolate_bilinear(x.float(), scale_factor=0.5)),
                wd, bd, 0))
    y5 = rd(_lrelu(conv(d, w1b, b1, 1)))
    e = rd(conv(rd(conv(y5, w2b, b2, 1)), wu, bu, 0))
    dres = interpolate_bilinear(e, scale_factor=2.0)
    out = (canvas[:, :h, :w] + dres + x.float()).to(dt)
    return (out, clipped) if clip_counts else out


def kernel_weights_s8(wq: torch.Tensor) -> torch.Tensor:
    """An int8 torch conv weight (N out, K in, kh, kw) in the layout
    ``csrc/conv3x3_tile.cuh`` reads for its s8 products: the
    ``mma.m16n8k32`` B-fragment order [tap][K/32][N/8][g][t][half][4], where
    lane 4g + t of a warp loads the 8 values n = 8nt + g, k = 32kt +
    16half + 4t .. 4t+3 as one 8-byte word."""
    n, k, kh, kw = wq.shape
    t = wq.permute(2, 3, 0, 1).reshape(kh * kw, n // 8, 8, k // 32, 2, 4, 4)
    return t.permute(0, 3, 1, 2, 5, 4, 6).contiguous()


@functools.lru_cache(maxsize=None)
def _conv1_order(c: int, device: torch.device) -> torch.Tensor:
    """The mid channel of a chunk at each conv1 stage row n = 8j + 2t + e:
    16 (j // 2) + 4t + 2 (j % 2) + e, so that the kernel's accumulator lane
    t holds bytes 4t .. 4t + 3 of each 16-byte chunk of a y pixel."""
    n = torch.arange(c)
    j, t, e = n // 8, (n % 8) // 2, n % 2
    return (16 * (j // 2) + 4 * t + 2 * (j % 2) + e).to(device)


def stage_weights_q(w1q, w2q, wfq) -> torch.Tensor:
    """conv1, the folded conv2 and conv2 (int8, torch layout) as the
    bfloat16 kernel streams them for each step: 136 stages of 64 n x 64 k,
    per chunk of 64 mid channels conv1's 9 taps (B[n][k]: mid channel 64 ch
    + ``_conv1_order``[n], input channel k), the fold's 16 and conv2's 9 (B[n][k]: output
    channel n, mid channel 64 ch + k); each stage in planes of 16-byte k
    chunks, [k // 16][n][k % 16], the swizzle-free K-major tile of
    ``csrc/wgmma_tile.cuh::wgmma_desc_plain``."""
    c = w2q.shape[0]
    conv1 = w1q.permute(2, 3, 0, 1).reshape(9, 4, c, c).transpose(0, 1)
    conv1 = conv1[:, :, _conv1_order(c, w1q.device)]
    fold = wfq.permute(2, 3, 0, 1).reshape(16, c, 4, c).permute(2, 0, 1, 3)
    conv2 = w2q.permute(2, 3, 0, 1).reshape(9, c, 4, c).permute(2, 0, 1, 3)
    stages = torch.cat([conv1, fold, conv2], dim=1).reshape(136, c, c)
    return stages.reshape(136, c, c // 16, 16).permute(0, 2, 1, 3) \
        .contiguous()


def stage_half_weights(w1b, w2b) -> torch.Tensor:
    """The dequantised conv1 and conv2 (bfloat16, torch layout) as the
    bfloat16 kernel's 0.5x branch streams them: (4 chunks, 18 stages, 64,
    64), per chunk of 64 mid channels conv1's 9 taps (A[m][k]: mid channel
    64 ch + m, input channel k) and conv2's 9 (B[n][k]: output channel n,
    mid channel 64 ch + k), 128-byte swizzled: ``fused_block2.stage_weights``
    without the fold."""
    c = w2b.shape[0]
    conv1 = w1b.permute(2, 3, 0, 1).reshape(9, 4, c, c)
    conv2 = w2b.permute(2, 3, 0, 1).reshape(9, c, 4, c).permute(0, 2, 1, 3)
    return swizzle128(torch.cat([conv1, conv2]).transpose(0, 1)
                      .contiguous())


def pack_weights_q(w1, b1, w2, b2, wd, bd, wu, bu, dtype):
    """The kernel's operands after x, in its argument order: int8 conv1,
    conv2 and folded conv2 with their float32 scales, the biases, the
    dequantised conv1 / conv2 and the 1x1 convs in ``dtype`` in
    ``cuda_build.kernel_weights``' layout, and the float32 step-0 bounds.
    The int8 weights: in float32 each in fragment order
    (``kernel_weights_s8``); in bfloat16 all three as ``stage_weights_q``
    in conv1's place, None in the others', and the dequantised conv1 and
    conv2 as ``stage_half_weights`` in w1b's place, None in w2b's. Callers
    cache it."""
    w1q, s1, w2q, s2, wfq, sf, bnd, w1b, w2b = quantize_block(w1, b1, w2,
                                                              dtype)

    def kw(wt):
        return cb.kernel_weights(wt, dtype)

    if dtype == torch.bfloat16:
        q1, q2, qf = stage_weights_q(w1q, w2q, wfq), None, None
        h1, h2 = stage_half_weights(w1b, w2b), None
    else:
        q1, q2, qf = (kernel_weights_s8(w1q), kernel_weights_s8(w2q),
                      kernel_weights_s8(wfq))
        h1, h2 = kw(w1b), kw(w2b)
    return (q1, s1.contiguous(), b1.to(dtype), q2, s2.contiguous(),
            b2.to(dtype), qf, sf.contiguous(), h1, h2, kw(wd),
            bd.to(dtype), kw(wu), bu.to(dtype), bnd.contiguous())


@functools.lru_cache(maxsize=None)
def _kernel():
    return cb.kernel_function("fused_block2_q", "cdfo_fused_block2_q",
                              [_P] * 19 + [_I] * 4 + [_P])


def scale_block_q(x, w1, b1, w2, b2, wd, bd, wu, bu, packed=None,
                  geometry: StepGeometry | None = None,
                  clip_counts: bool = False):
    """The int8 Block_ of ``scale_block_q_plain``; ``packed``: this
    block's ``pack_weights_q`` in x's dtype, if the caller keeps it.
    ``geometry`` (None: ``KERNEL_GEOMETRY``) is the plain version's on a
    CPU tensor; the kernel has one geometry and refuses another. With
    ``clip_counts`` returns (out, float64 (2,) clipped y1 and y2 values)."""
    params = (w1, b1, w2, b2, wd, bd, wu, bu)
    cb.forbid_grad("fused_block2_q", x, *params)
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"fused_block2_q needs even H and W (the reference "
                         f"Block_ is undefined otherwise), got "
                         f"{tuple(x.shape)}")
    geometry = KERNEL_GEOMETRY if geometry is None else geometry
    if not cb.on_card(x, "fused_block2_q"):
        return scale_block_q_plain(x, *params, geometry=geometry,
                                   clip_counts=clip_counts)
    if geometry != KERNEL_GEOMETRY:
        raise ValueError(f"fused_block2_q: the kernel walks "
                         f"{KERNEL_GEOMETRY}, not {geometry}")
    cb.check_operands("fused_block2_q", x, *params, channels=CHANNELS)
    c = CHANNELS
    if (w1.shape != (4 * c, c, 3, 3) or w2.shape != (c, 4 * c, 3, 3)
            or wd.shape != (c, c, 1, 1) or wu.shape != (c, c, 1, 1)):
        raise ValueError(f"fused_block2_q: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(wd.shape)}, "
                         f"{tuple(wu.shape)}")
    if packed is None:
        packed = pack_weights_q(*params, x.dtype)
    bsz, h, wdt, _ = x.shape
    out = torch.empty_like(x)
    strips = -(-wdt // KERNEL_GEOMETRY.cols)
    counts = (torch.zeros(bsz * strips, 2, dtype=torch.float32,
                          device=x.device) if clip_counts else None)
    e = (torch.empty(bsz, h // 2, wdt // 2, c, dtype=x.dtype,
                     device=x.device)
         if x.dtype == torch.bfloat16 else None)   # the 0.5x branch's output
    cb.launch(_kernel(), "fused_block2_q", x.device, x.data_ptr(),
              *pointers(packed), out.data_ptr(), *pointers((counts, e)),
              cb.DTYPE_CODES[x.dtype], bsz, h, wdt)
    scale_block_q.launches += 1
    if clip_counts:
        return out, counts.double().sum(dim=0)
    return out


scale_block_q.launches = 0
