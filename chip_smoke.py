#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cdfo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU mode: without a
CUDA device the script exits non-zero before printing any result):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build of the hand-written CUDA kernel from ``cdfo_tpu_torch/csrc``;
3. the kernel against its plain PyTorch version on the card, at the main
   path's row and column shapes and at ragged shapes, in float32 and
   bfloat16, with kernel and plain times (CUDA events, median of 15);
4. a small CVSR_V8 (2 trunk groups, 16x24 frames) through the streaming
   engine on the card (float32, kernel on, TF32 off) against the same
   weights through the same engine on the CPU (plain versions): uint8
   frames within 1 LSB;
5. the full-width slice: CVSR_V8 at its default widths (nf=64, 7 trunk
   groups), bfloat16, seeded random weights, ``BatchedStreamingEngine(k=4)``
   on a 12-frame 272x480 synthetic sequence in timed mode; checks the
   (12, 1080, 1920) uint8 output and that every ``compensate_frames`` call
   launched the attention kernel twice (row and column stage).

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

# max |kernel - plain| allowed, relative to max |plain|: float32 differs
# only in summation order; bfloat16 rounds p and the output to 8 mantissa
# bits (one output ulp is 2^-8 of the largest value), so 4 ulps
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
SOURCE = "cdfo_tpu_torch/csrc/fused_attention.cu"
REPLACES = "cdfo_tpu/ops/fused_attention.py:43"
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


def check_small_slice():
    """Phase 4: card (kernel) vs CPU (plain versions), one set of weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(scn_groups=2)
    data = synthetic_sequence(t=9, h=16, w=24, seed=3)
    frames = {}
    for dev in ("cpu", "cuda"):
        model = CVSRV8(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
        frames[dev], _ = BatchedStreamingEngine(model, k=4).run_sequence(data)
    diff = np.abs(frames["cuda"].astype(np.int32)
                  - frames["cpu"].astype(np.int32))
    print(f"small slice (nf=64, 2 groups, 9x16x24, k=4, fp32): card vs CPU "
          f"max diff {diff.max()} LSB over {diff.size} pixels", flush=True)
    if diff.max() > 1 or frames["cuda"].std() == 0:
        raise AssertionError("small-slice card output disagrees with CPU")


def run_full_slice(card: str) -> dict:
    """Phase 5; returns the launches per wrapper in the timed run."""
    t, k = 12, 4
    cfg = ModelConfig(compute_dtype=torch.bfloat16)
    model = CVSRV8(cfg, generator=torch.Generator().manual_seed(0),
                   device="cuda")
    data = synthetic_sequence(t=t, h=272, w=480, seed=0)
    eng = BatchedStreamingEngine(model, k=k)
    t0 = time.perf_counter()
    eng.run_sequence(data)   # warm-up: cuDNN/cuBLAS plans, allocator
    print(f"full slice warm-up run {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, fps = eng.run_sequence(data, collect_timing=True)
    launches = {"token": fa.token_self_attention.launches,
                "column": fa.column_self_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = 1 + len(range(0, t, k))   # bootstrap + one per step
    print(f"full slice (CVSR_V8 nf=64, 7 groups, bf16, 272x480 -> 1080x1920, "
          f"k={k}, {t} frames): {fps:.3f} fps by the reference protocol, "
          f"peak memory {peak:.2f} GiB [{card}]", flush=True)
    print(f"compensate_frames calls {calls}, kernel launches {launches}",
          flush=True)
    if frames.shape != (t, 1080, 1920) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")
    if frames.std() == 0:
        raise AssertionError("full-slice output is constant")
    if launches != {"token": calls, "column": calls}:
        raise AssertionError(f"expected 2 launches per compensate_frames "
                             f"call ({calls} calls), got {launches}")
    return launches


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
    fa.build()
    print(f"built {SOURCE} in {time.perf_counter() - t0:.1f} s "
          f"({cuda_build.library_path('fused_attention').name})", flush=True)
    log = cuda_build.library_path("fused_attention").with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.replace('ptxas info    :', 'ptxas:').strip()}",
                  flush=True)

    fields = check_kernels(card)
    check_small_slice()
    launches = run_full_slice(card)

    print(json.dumps({"kernels": [
        {"name": f"fused_attention.{kind}_self_attention", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES,
         "launches": launches[kind], **fields[kind]}
        for kind in ("token", "column")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
