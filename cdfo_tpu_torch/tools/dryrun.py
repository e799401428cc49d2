"""Multi-card dry run of the port (the repository's
``__graft_entry__.py::dryrun_multichip``), over the ranks that ``torchrun``
starts, one card each, or CPU ranks with ``--cpu``:

    torchrun --nproc-per-node 4 -m cdfo_tpu_torch.tools.dryrun
    torchrun --nproc-per-node 2 -m cdfo_tpu_torch.tools.dryrun --cpu
    python -m cdfo_tpu_torch.tools.dryrun --cpu      # a group of one

It runs two data-parallel train steps of the full-depth CVSR_V8 (seven trunk
groups, the sampled mask) on a global batch of 2 rows a rank of 7 16x16
frames, each rank on its own rows, and requires finite losses; saves the
state on rank 0 and restores it on every rank into a fresh state, whose
parameters must equal the trained ones; then serves ``2 * world`` frames of
16x24 through ``ShardedServingEngine`` at ``k_per_device=1`` (a one-group
model, the expected mask). Rank 0 prints one line. Without CUDA and
without ``--cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def global_batch(rows: int, n: int = 7, h: int = 16, w: int = 16) -> dict:
    """The seeded global batch (``__graft_entry__._example_inputs``'
    draws)."""
    r = np.random.RandomState(0)
    lrs = r.rand(rows, n, h, w, 1).astype(np.float32)
    mvs0 = (r.randn(rows, n, h, w, 2) * 0.5).astype(np.float32)
    mvs1 = (r.randn(rows, n, h, w, 2) * 0.5).astype(np.float32)
    pms = r.rand(rows, n, h, w, 1).astype(np.float32)
    rms = (r.rand(rows, n, h, w, 1).astype(np.float32) - 0.5) * 0.2
    ufs = r.rand(rows, n, h, w, 1).astype(np.float32)
    hr = np.random.RandomState(1).rand(rows, 4 * h, 4 * w, 1) \
        .astype(np.float32)
    return {"lrs": lrs, "mvs0": mvs0, "mvs1": mvs1, "pms": pms, "rms": rms,
            "ufs": ufs, "hr": hr}


def run(device: torch.device, rank: int, world: int) -> str:
    """The dry run on this rank; returns its summary line."""
    from ..config import ModelConfig, TrainConfig
    from ..infer import synthetic_sequence
    from ..models import CVSRV8
    from ..parallel import shard_rows
    from ..parallel.serving import ShardedServingEngine
    from ..train.loop import (latest_checkpoint, restore_checkpoint,
                              save_checkpoint)
    from ..train.state import TrainState, train_step

    batch = {k: shard_rows(v, rank, world)
             for k, v in global_batch(2 * world).items()}
    cfg = ModelConfig(mask_mode="sample")

    def fresh_state():
        model = CVSRV8(cfg, torch.Generator().manual_seed(0), device=device)
        return TrainState(model, TrainConfig())

    state = fresh_state()
    generator = torch.Generator(device=device).manual_seed(0)
    losses = [train_step(state, batch, generator).item() for _ in range(2)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")

    # rank 0 writes, every rank restores from the same file
    holder = [tempfile.mkdtemp(prefix="cdfo_dryrun_") if rank == 0 else None]
    dist.broadcast_object_list(holder)
    if rank == 0:
        save_checkpoint(holder[0], state)
    dist.barrier()
    restored = restore_checkpoint(latest_checkpoint(holder[0]), fresh_state())
    for name, p in state.model.state_dict().items():
        if not torch.equal(p, restored.model.state_dict()[name]):
            raise AssertionError(f"restored {name} differs")
    if restored.step != state.step:
        raise AssertionError(f"restored step {restored.step}")
    dist.barrier()
    if rank == 0:
        shutil.rmtree(holder[0], ignore_errors=True)

    smodel = CVSRV8(ModelConfig(mask_mode="expected", scn_groups=1),
                    torch.Generator().manual_seed(1), device=device)
    eng = ShardedServingEngine(smodel, k_per_device=1)
    frames, _ = eng.run_sequence(
        synthetic_sequence(t=2 * world, h=16, w=24, seed=7))
    if frames.shape != (2 * world, 64, 96) or frames.dtype != np.uint8:
        raise AssertionError(f"served frames {frames.shape} {frames.dtype}")
    return (f"dryrun_multichip OK: world={world} ({device.type}) "
            f"loss0={losses[0]:.2f} loss1={losses[1]:.2f} ckpt-roundtrip ok "
            f"sharded-serving k={eng.k} ok")


def main(argv=None):
    p = argparse.ArgumentParser(description="cdfo_tpu_torch multi-card "
                                "dry run")
    p.add_argument("--cpu", action="store_true",
                   help="CPU ranks over gloo (the kernels' plain versions)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("cdfo_tpu_torch.tools.dryrun runs on the card and "
                 "torch.cuda.is_available() is False; pass --cpu to run on "
                 "the CPU")
    from ..parallel import initialize_distributed, rank_device

    device_type = "cpu" if args.cpu else "cuda"
    rank, world = initialize_distributed(device_type)
    try:
        line = run(rank_device(device_type), rank, world)
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
