"""Streaming-serving CLI of the port (the repository's ``tools/serve.py``):
the streaming engine over every rank that ``torchrun`` starts, one card
each, the k output frames of each step split over them
(``parallel/serving.py``); started alone, the plain engine on one card.
``--cpu`` runs the ranks on the CPU over gloo (correctness, not speed), in
place of the JAX tool's ``--cpu-mesh N``:

    python -m cdfo_tpu_torch.tools.serve --frames 64
    torchrun --nproc-per-node 4 -m cdfo_tpu_torch.tools.serve --frames 64
    torchrun --nproc-per-node 4 -m cdfo_tpu_torch.tools.serve --cpu \\
        --frames 16 --height 64 --width 96 --k-per-device 1
    python -m cdfo_tpu_torch.tools.serve --ckpt LD_QP37.pth \\
        --lr-dir <pngs> --side-dir <priors> --save-dir <out>

The model is the JAX tool's: CVSR_V8 with the expected mask, bf16 unless
``--fp32``, with ``fused_trunk``, ``fused_embed`` and ``fused_align`` on the
card; seven trunk groups on the card or with ``--ckpt`` / ``--lr-dir``, one
for the synthetic CPU demo. ``--ckpt`` takes the port's ``step_%08d.pt``
or a released ``.pth``. Rank 0 prints one JSON line: ``mode``,
``devices``, ``geometry``, ``frames``, ``fps`` (the timed run's) and, with
``--save-dir``, ``saved``. Without CUDA and without ``--cpu`` it exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cdfo_tpu_torch serving")
    p.add_argument("--frames", default=32, type=int)
    p.add_argument("--height", default=272, type=int)
    p.add_argument("--width", default=480, type=int)
    p.add_argument("--k-per-device", default=4, type=int)
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU (the kernels' plain "
                        "versions, gloo)")
    p.add_argument("--ckpt", default="",
                   help="a port checkpoint (step_%%08d.pt) or a released "
                        ".pth")
    p.add_argument("--lr-dir", default="",
                   help="serve a real sequence: LR PNG dir (with "
                        "--side-dir), JCT-VC grammar as tools/test_sr.py")
    p.add_argument("--side-dir", default="")
    p.add_argument("--save-dir", default="",
                   help="write SR PNGs here (with --lr-dir)")
    p.add_argument("--fp32", dest="bf16", action="store_false", default=True)
    args = p.parse_args(argv)
    if args.lr_dir and not args.side_dir:
        p.error("--lr-dir requires --side-dir (the coding-priors tree; "
                "JCT-VC grammar as tools/test_sr.py)")
    return args


def main(argv=None):
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("cdfo_tpu_torch.tools.serve runs on the card and "
                 "torch.cuda.is_available() is False; pass --cpu to run on "
                 "the CPU")

    from ..config import ModelConfig
    from ..data.io import load_eval_sequence, write_gray
    from ..infer import BatchedStreamingEngine, synthetic_sequence
    from ..models import CVSRV8
    from ..parallel import initialize_distributed, rank_device
    from ..parallel.serving import ShardedServingEngine
    from .test_sr import load_weights

    device_type = "cpu" if args.cpu else "cuda"
    rank, world = 0, int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        rank, world = initialize_distributed(device_type)
    try:
        fused = not args.cpu
        # real checkpoints need the full-depth trunk; the synthetic demo on
        # the CPU keeps one trunk group
        full_depth = fused or bool(args.ckpt) or bool(args.lr_dir)
        cfg = ModelConfig(
            mask_mode="expected",
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
            fused_trunk=fused, fused_embed=fused, fused_align=fused,
            scn_groups=7 if full_depth else 1)
        model = CVSRV8(cfg, torch.Generator().manual_seed(0),
                       device=rank_device(device_type))
        if args.ckpt:
            load_weights(model, args.ckpt)
        if args.lr_dir:
            data = load_eval_sequence(args.lr_dir, args.side_dir,
                                      args.frames or None)
            h, w = data.lr.shape[1:]
        else:
            h, w = args.height, args.width
            data = synthetic_sequence(t=args.frames, h=h, w=w, seed=0)

        if world > 1:
            eng = ShardedServingEngine(model, k_per_device=args.k_per_device)
            mode = f"sharded over {world} devices (k={eng.k})"
        else:
            eng = BatchedStreamingEngine(model, k=args.k_per_device)
            mode = f"single device (k={eng.k})"
        eng.run_sequence(synthetic_sequence(t=2 * eng.k, h=h, w=w, seed=1))
        frames, fps = eng.run_sequence(data, collect_timing=True)
        if rank != 0:
            return
        if args.save_dir:
            os.makedirs(args.save_dir, exist_ok=True)
            for i, frame in enumerate(frames):
                write_gray(os.path.join(args.save_dir, "%05d.png" % i), frame)
        print(json.dumps({
            "mode": mode, "devices": world,
            "geometry": f"{h}x{w} -> {4 * h}x{4 * w}",
            "frames": int(frames.shape[0]),
            "fps": round(float(fps), 3),
            **({"saved": args.save_dir} if args.save_dir else {}),
        }), flush=True)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
