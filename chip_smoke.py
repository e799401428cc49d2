#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cdfo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU mode: without a
CUDA device the script exits non-zero before printing any result):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build of every hand-written CUDA kernel from ``cdfo_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once, with each library's ``ptxas``
   register and spill lines;
3. each kernel against its plain PyTorch version on the card, in float32
   and bfloat16, with kernel and plain times (CUDA events, median of 15) at
   the main path's shapes: the attention kernel at its row and column
   shapes and at ragged ones; the four fused-trunk kernels (``Block_``,
   group tail, head, alignment tail) at the 272x480, k=4 shapes and at a
   ragged even shape; an odd extent must be refused;
4. two small CVSR_V8 (2 trunk groups, 16x24 frames) through the streaming
   engine on the card (float32, kernels on, TF32 off) against the same
   weights through the same engine on the CPU (plain versions): uint8
   frames within 1 LSB, once with ``fused_trunk`` off and once on;
5. the full-width slice: CVSR_V8 at its default widths (nf=64, 7 trunk
   groups), bfloat16, seeded random weights, ``BatchedStreamingEngine(k=4)``
   on a 12-frame 272x480 synthetic sequence in timed mode, with
   ``fused_trunk`` off and then on (the same weights); checks the
   (12, 1080, 1920) uint8 output, that every ``compensate_frames`` call
   launched the attention kernel twice (row and column stage), that every
   ``align_reconstruct`` call of the fused run launched 21 ``Block_``, 7
   group-tail, 1 head and 1 tail kernels, and that the fused frames are
   within 40 dB PSNR of the unfused ones.

The line before the last is a JSON object with one entry per kernel
wrapper; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.infer import BatchedStreamingEngine, synthetic_sequence
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.ops import cuda_build
from cdfo_tpu_torch.ops import fused_attention as fa
from cdfo_tpu_torch.ops import fused_block2 as fb
from cdfo_tpu_torch.ops import fused_groupconv as fg
from cdfo_tpu_torch.ops import fused_head as fh
from cdfo_tpu_torch.ops import fused_tail as ft

# max |kernel - plain| allowed, relative to max |plain|: float32 differs
# only in summation order; bfloat16 rounds intermediates and the output to
# 8 mantissa bits (one output ulp is 2^-8 of the largest value), at other
# points than eager PyTorch, so 4 ulps
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
SOURCE = "cdfo_tpu_torch/csrc/fused_attention.cu"
REPLACES = "cdfo_tpu/ops/fused_attention.py:43"
LIBRARIES = ("fused_attention", "fused_block2", "fused_groupconv",
             "fused_head", "fused_tail")
# the fused-trunk kernels: JSON name, wrapper, plain version, source, the
# TPU kernel it replaces
TRUNK_KERNELS = {
    "block": ("fused_block2.scale_block", fb.scale_block,
              fb.scale_block_plain, "cdfo_tpu_torch/csrc/fused_block2.cu",
              "cdfo_tpu/ops/fused_block2.py:375"),
    "group": ("fused_groupconv.grouptail", fg.grouptail, fg.grouptail_plain,
              "cdfo_tpu_torch/csrc/fused_groupconv.cu",
              "cdfo_tpu/ops/fused_groupconv.py:107"),
    "head": ("fused_head.fused_head", fh.fused_head, fh.fused_head_plain,
             "cdfo_tpu_torch/csrc/fused_head.cu",
             "cdfo_tpu/ops/fused_head.py:207"),
    "tail": ("fused_tail.resblock_pair", ft.resblock_pair,
             ft.resblock_pair_plain, "cdfo_tpu_torch/csrc/fused_tail.cu",
             "cdfo_tpu/ops/fused_tail.py:193"),
}
# per align_reconstruct call at 7 trunk groups
TRUNK_LAUNCHES = {"block": 21, "group": 7, "head": 1, "tail": 1}
# NHWC shapes: the main path's at 272x480, k=4 (the tail's batch is 6k
# neighbour images, 3 neighbours per image in the ragged case), then ragged
# ones (not multiples of any tile)
TRUNK_MAIN = (4, 272, 480, 64)
TRUNK_SHAPES = (TRUNK_MAIN, (2, 18, 34, 64))
# (wrapper, shape): the main path's row and column shapes at 272x480, k=4,
# then ragged ones (N not a multiple of the 64-row tile)
KERNEL_CASES = [
    ("token", (1088, 480, 64)),
    ("column", (4, 272, 480, 64)),
    ("token", (3, 270, 64)),
    ("token", (2, 33, 64)),
    ("column", (2, 33, 20, 64)),
]
WRAPPERS = {
    "token": (fa.token_self_attention, fa.token_attention_plain),
    "column": (fa.column_self_attention, fa.column_attention_plain),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int = 15) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def reset_launches():
    fa.token_self_attention.launches = 0
    fa.column_self_attention.launches = 0
    for _, wrapper, *_ in TRUNK_KERNELS.values():
        wrapper.launches = 0


def trunk_args(kind, shape, dtype, g):
    """Inputs of one fused-trunk kernel at NHWC ``shape``, drawn from
    ``g``; the tail gets 6 neighbours per image at the main shape, else 3."""
    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device="cuda") * scale).to(dtype)

    def rand(*s):
        return torch.rand(*s, generator=g, device="cuda").to(dtype)

    c = shape[-1]
    if kind == "block":
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
    nbr = 6 if shape == TRUNK_MAIN else 3
    ws = []
    for _ in range(4):
        ws += [rnd(c, c, 3, 3, scale=0.05), rnd(c, scale=0.1)]
    return (rnd(nbr * shape[0], *shape[1:]), rnd(*shape),
            rand(nbr * shape[0], c), *ws)


@torch.no_grad()
def check_trunk_kernels(card: str) -> dict:
    """Phase 3, fused-trunk part; returns the JSON fields of each kernel,
    measured at the main path's shape in bfloat16 (the full slice's dtype).
    TF32 is off, so the float32 plain side is full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    fields = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in TRUNK_SHAPES:
            for kind, (name, kernel, plain, _, _) in TRUNK_KERNELS.items():
                args = trunk_args(kind, shape, dtype, g)
                out = kernel(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                line = (f"kernel {name} {shape} {str(dtype)[6:]}: max_abs_err "
                        f"{err:.3e} (max |plain| {scale:.3f}, rel "
                        f"{err / scale:.3e}, tolerance rel "
                        f"{TOLERANCE[dtype]:.1e})")
                if shape == TRUNK_MAIN:
                    ms = median_ms(lambda: kernel(*args))
                    plain_ms = median_ms(lambda: plain(*args))
                    line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                             f"[{card}]")
                    if dtype == torch.bfloat16:
                        fields[kind] = {"max_abs_err": err, "ms": ms,
                                        "plain_ms": plain_ms}
                print(line, flush=True)
                if not err <= TOLERANCE[dtype] * scale:
                    raise AssertionError(f"kernel disagrees with plain: "
                                         f"{line}")
                del args, out, ref
            torch.cuda.empty_cache()
    odd = trunk_args("block", (1, 16, 23, 64), torch.bfloat16, g)
    try:
        fb.scale_block(*odd)
    except ValueError as e:
        print(f"odd extent refused: {e}", flush=True)
    else:
        raise AssertionError("fused_block2 took an odd extent")
    return fields


def check_kernels(card: str) -> dict:
    """Phase 3; returns the JSON fields of each wrapper, measured at the
    main path's shape in float32 (the dtype the main path gives it: EGLA's
    9-tap convs promote to float32 even in a bfloat16 model)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    fields = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind, shape in KERNEL_CASES:
            kernel, plain = WRAPPERS[kind]
            q = (torch.randn(shape, generator=g, device="cuda") * 0.35
                 ).to(dtype)
            v = torch.randn(shape, generator=g, device="cuda").to(dtype)
            out = kernel(q, v)
            ref = plain(q, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = TOLERANCE[dtype] * scale
            line = (f"kernel {kind} {tuple(shape)} {str(dtype)[6:]}: "
                    f"max_abs_err {err:.3e} (max |plain| {scale:.3f}, "
                    f"rel {err / scale:.3e}, tolerance rel "
                    f"{TOLERANCE[dtype]:.1e})")
            main = shape == KERNEL_CASES[0 if kind == "token" else 1][1]
            if main:
                ms = median_ms(lambda: kernel(q, v))
                plain_ms = median_ms(lambda: plain(q, v))
                line += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]"
                if dtype == torch.float32:
                    fields[kind] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms}
            print(line, flush=True)
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain: {line}")
            del q, v, out, ref
    return fields


def check_small_slice(fused: bool):
    """Phase 4: card (kernels) vs CPU (plain versions), one set of
    weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(scn_groups=2, fused_trunk=fused)
    data = synthetic_sequence(t=9, h=16, w=24, seed=3)
    frames = {}
    for dev in ("cpu", "cuda"):
        model = CVSRV8(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
        frames[dev], _ = BatchedStreamingEngine(model, k=4).run_sequence(data)
    diff = np.abs(frames["cuda"].astype(np.int32)
                  - frames["cpu"].astype(np.int32))
    print(f"small slice (nf=64, 2 groups, 9x16x24, k=4, fp32, fused_trunk="
          f"{fused}): card vs CPU max diff {diff.max()} LSB over {diff.size} "
          f"pixels", flush=True)
    if diff.max() > 1 or frames["cuda"].std() == 0:
        raise AssertionError("small-slice card output disagrees with CPU")


def run_full_slice(card: str, fused: bool):
    """Phase 5 for one setting of ``fused_trunk``; returns (frames, the
    launches per wrapper in the timed run)."""
    t, k = 12, 4
    cfg = ModelConfig(compute_dtype=torch.bfloat16, fused_trunk=fused)
    model = CVSRV8(cfg, generator=torch.Generator().manual_seed(0),
                   device="cuda")
    data = synthetic_sequence(t=t, h=272, w=480, seed=0)
    eng = BatchedStreamingEngine(model, k=k)
    t0 = time.perf_counter()
    eng.run_sequence(data)   # warm-up: cuDNN/cuBLAS plans, allocator
    print(f"full slice fused_trunk={fused}: warm-up run "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, fps = eng.run_sequence(data, collect_timing=True)
    launches = {"token": fa.token_self_attention.launches,
                "column": fa.column_self_attention.launches}
    launches.update({kind: wrapper.launches
                     for kind, (_, wrapper, *_) in TRUNK_KERNELS.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(range(0, t, k))
    calls = 1 + steps   # compensate_frames: bootstrap + one per step
    print(f"full slice (CVSR_V8 nf=64, 7 groups, bf16, 272x480 -> 1080x1920, "
          f"k={k}, {t} frames, fused_trunk={fused}): {fps:.3f} fps by the "
          f"reference protocol, peak memory {peak:.2f} GiB [{card}]",
          flush=True)
    print(f"compensate_frames calls {calls}, align_reconstruct calls {steps}, "
          f"kernel launches {launches}", flush=True)
    if frames.shape != (t, 1080, 1920) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")
    if frames.std() == 0:
        raise AssertionError("full-slice output is constant")
    want = {"token": calls, "column": calls}
    want.update({kind: n * steps if fused else 0
                 for kind, n in TRUNK_LAUNCHES.items()})
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    del model, eng
    torch.cuda.empty_cache()
    return frames, launches


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs the port on a GPU and has no CPU mode")
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    try:
        cuda_build.build(*LIBRARIES)
    finally:
        for name in LIBRARIES:
            log = cuda_build.library_path(name).with_suffix(".log")
            if not log.exists():
                continue
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "rror" in line:
                    line = line.replace("ptxas info    :", "ptxas:").strip()
                    print(f"  {name}: {line}", flush=True)
    print(f"built {len(LIBRARIES)} libraries in parallel in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    fields = check_kernels(card)
    fields.update(check_trunk_kernels(card))
    check_small_slice(fused=False)
    check_small_slice(fused=True)
    plain_frames, _ = run_full_slice(card, fused=False)
    frames, launches = run_full_slice(card, fused=True)
    quality = psnr(frames, plain_frames)
    print(f"full slice: fused vs unfused uint8 frames PSNR {quality:.2f} dB "
          f"(max diff {np.abs(frames.astype(np.int32) - plain_frames).max()} "
          f"LSB)", flush=True)
    if not quality >= 40.0:
        raise AssertionError(f"fused frames are {quality:.2f} dB from the "
                             "unfused ones (limit 40 dB)")

    kernels = [
        {"name": f"fused_attention.{kind}_self_attention", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES,
         "launches": launches[kind], **fields[kind]}
        for kind in ("token", "column")]
    kernels += [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[kind], **fields[kind]}
        for kind, (name, _, _, source, replaces) in TRUNK_KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
