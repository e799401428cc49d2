"""Dot-shape probe on the GPU, the port of ``tools/microbench_dots.py``:
how does the sustained rate of bf16 ``wgmma`` with both operands in shared
memory (the main-path kernels' instruction) go with N, the probe's M
(output channels: 64, 128, 256), what does splitting weights that fit no
SM cost, and does the ``Block_``'s per-row issue lose to K-stacked issue?

  --mode dots     one (M, K, N) product repeated over 4 resident planes
                  (``ops/probe_dots.dot_case``; K split over CTAs where
                  the weights and planes fit no CTA)
  --mode rowpipe  the fused ``Block_``'s y-row pipeline: three dx-shifted
                  products, bias, lrelu, mask, bf16 store per row (the
                  weights split by output channels, or at C = 256 by
                  input channels over a cluster of C / 64 CTAs)
  --mode kstack   the K-stacked row pipeline: one row built into three
                  shifted copies in shared memory, then one product of
                  K = 9C per row; each case is followed by rowpipe at
                  kstack's tile (64-channel m-tiles a CTA), so that the
                  two differ only in issue order and the build

Each case first holds the kernel against its plain version
(``ops/kernel_cases.py``'s tolerance), then times it at two rep counts
(best of ``--iters`` calls each, CUDA events) and reports the rate of the
difference, as the TPU tool does to cancel its readback floor (here the
fixed costs: the layout copies, the partial-sum launch). Case lists and rep
counts are the TPU tool's.

    python -m cdfo_tpu_torch.tools.microbench_dots [--mode dots] [--iters 4]
"""
from __future__ import annotations

import argparse
import functools

import torch

from ..ops import kernel_cases as kc
from ..ops import probe_dots as pd
from . import event_ms, require_card

DOT_CASES = [
    (256, 192, 516),    # conv1-style per-row dot (shipped)
    (256, 192, 1032),   # N x2
    (256, 192, 2064),   # N x4 (frame-packing target)
    (64, 768, 516),     # conv2-style per-row dot (shipped)
    (64, 768, 1032),
    (64, 768, 2064),
    (64, 1024, 516),    # folded down.conv2 dot (shipped)
    (64, 1024, 2064),
    (256, 576, 516),    # K-stacked conv1 (all 9 taps in one dot)
    (128, 128, 516),    # granularity reference points
    (128, 128, 2064),
]
# (M, C, N): conv1-style rows at the shipped and packed widths
ROWPIPE_CASES = [(256, 64, 516), (256, 64, 1032), (256, 64, 2064),
                 (64, 256, 516), (64, 256, 2064)]
# conv1-style at 1x / 2x widths, against the rowpipe 3-dot baseline
KSTACK_CASES = [(256, 64, 516), (256, 64, 1032)]


def _check(out, ref, what):
    err, scale = kc.worst_error(out, ref)
    tol = kc.tolerance(torch.bfloat16)
    if not err <= tol * scale:
        raise AssertionError(f"{what}: kernel against plain rel "
                             f"{err / scale:.3e} > {tol:.1e}")
    return err / scale


def _diff(fn, flop_it, reps_hi, iters):
    reps_lo = reps_hi // 2
    t_lo = min(event_ms(lambda: fn(reps_lo), iters)) / 1e3
    t_hi = min(event_ms(lambda: fn(reps_hi), iters)) / 1e3
    dt = max(t_hi - t_lo, 1e-9)
    return t_lo, t_hi, flop_it * (reps_hi - reps_lo) / dt / 1e12


@torch.no_grad()
def bench_case(m, k, n, *, iters=4, nplanes=4, seed=0):
    """Checks then times one dot case; prints the TPU tool's line and
    returns (TF/s, relerr against the plain version)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs, rhs = kc.dots_args(g, m, k, n, nplanes)
    reps_hi = max(2, int(4e12 / (2 * m * k * n)))
    rel = _check(pd.dot_case(lhs, rhs, reps_hi // 2),
                 pd.dot_case_plain(lhs, rhs, reps_hi // 2),
                 f"dots {m} {k} {n}")
    t_lo, t_hi, tfs = _diff(lambda reps: pd.dot_case(lhs, rhs, reps),
                            2.0 * m * k * n, reps_hi, iters)
    print(f"M={m:4d} K={k:4d} N={n:5d}: lo={t_lo * 1e3:7.2f} ms "
          f"hi={t_hi * 1e3:7.2f} ms  diff -> {tfs:7.1f} TF/s  (relerr "
          f"{rel:.1e})", flush=True)
    return tfs, rel


@torch.no_grad()
def bench_rows(kind, m, c, n, *, nrows=8, iters=4, seed=0, mt=None):
    """``rowpipe`` (at ``mt`` m-tiles per warp where given) or ``kstack``:
    checks then times one case; prints the TPU tool's line and returns
    (TF/s, relerr)."""
    wrapper, plain = {"rowpipe": (pd.rowpipe, pd.rowpipe_plain),
                      "kstack": (pd.kstack, pd.kstack_plain)}[kind]
    if mt is not None:
        wrapper = functools.partial(wrapper, mt=mt)
    g = torch.Generator(device="cuda").manual_seed(seed)
    args = kc.rows_args(g, m, c, n, nrows)
    flop_it = 2.0 * m * 9 * c * n
    reps_hi = max(2 * nrows + 2, int(3e12 / flop_it))
    rel = _check(wrapper(*args, reps_hi // 2, nrows),
                 plain(*args, reps_hi // 2, nrows), f"{kind} {m} {c} {n}")
    t_lo, t_hi, tfs = _diff(lambda reps: wrapper(*args, reps, nrows),
                            flop_it, reps_hi, iters)
    tile = "" if mt is None else f"  (at kstack's tile, {mt} m-tiles/CTA)"
    print(f"{kind:7s} M={m:4d} C={c:3d} N={n:5d}: lo={t_lo * 1e3:7.2f} ms "
          f"hi={t_hi * 1e3:7.2f} ms  diff -> {tfs:7.1f} TF/s  (relerr "
          f"{rel:.1e}){tile}", flush=True)
    return tfs, rel


def main(argv=None) -> dict:
    """Runs the mode's case list; returns {case: (TF/s, relerr)}."""
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--mode", default="dots",
                   choices=["dots", "rowpipe", "kstack"])
    args = p.parse_args(argv)
    card = require_card("microbench_dots")
    print(f"microbench_dots --mode {args.mode} on {card}", flush=True)
    if args.mode == "dots":
        return {case: bench_case(*case, iters=args.iters)
                for case in DOT_CASES}
    if args.mode == "rowpipe":
        return {case: bench_rows("rowpipe", *case, iters=args.iters)
                for case in ROWPIPE_CASES}
    results = {}
    for case in KSTACK_CASES:
        results[case] = bench_rows("kstack", *case, iters=args.iters)
        bench_rows("rowpipe", *case, iters=args.iters,
                   mt=pd.kstack_mt(case[0], case[1], 8))
    return results


if __name__ == "__main__":
    main()
