"""The training loop (``cdfo_tpu/train/loop.py``; the reference's
`train_LD_37.py:299-415`): train steps over the batcher, a checkpoint every
``val_interval`` epochs, automatic resume from the newest one, and a JSONL
log of each epoch's mean loss.

A checkpoint (``step_%08d.pt``, ``torch.save``) holds the model's and the
float32 masters' values, the optimizer state, the step and the state of
the generator that draws the EGLA mask's gumbel noise. After each
checkpoint the loop calls the periodic eval hook, if given
(``make_eval_fn``). TensorBoard scalars are not ported yet (``log_dir``
raises).

Data-parallel (a default process group exists,
``parallel.initialize_distributed``): rank ``host_id`` of ``num_hosts``
reads every ``num_hosts``-th sequence and samples ``batch_size`` rows a
step, so a step covers ``num_hosts * batch_size`` rows, as ``cdfo_tpu``'s
multi-host run does; the ranks' gradients are summed in each step
(``train/state.py``). Rank 0 writes the checkpoints, a barrier follows
each, and every rank resumes from the newest; the JSONL log, the prints and
the eval hook are rank 0's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import DataConfig, ModelConfig, TrainConfig
from ..data.dataset import CVCPDataset, TrainBatcher
from ..models import CVSRV8
from .state import TrainState, train_step

_CKPT = re.compile(r"step_(\d{8})\.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    generator: Optional[torch.Generator] = None) -> str:
    """Writes ``<ckpt_dir>/step_%08d.pt`` (the state and, if given, the
    gumbel generator's state) and returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir,
                                        f"step_{state.step:08d}.pt"))
    blob = state.state_dict()
    if generator is not None:
        blob["generator"] = generator.get_state()
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, state: TrainState,
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """Loads ``path`` into ``state`` (and ``generator``, if the checkpoint
    holds its state) in place; returns ``state``."""
    blob = torch.load(path, map_location=state.device, weights_only=True)
    state.load_state_dict(blob)
    if generator is not None and "generator" in blob:
        generator.set_state(blob["generator"].cpu())
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The path of the newest ``step_%08d.pt`` in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if _CKPT.fullmatch(d))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def make_eval_fn(model_cfg: ModelConfig, lr_dir: str, side_dir: str,
                 gt_dir: str, max_frames: Optional[int] = 32,
                 device: torch.device | str = "cuda") -> Callable:
    """Periodic-eval hook (the reference's per-`val_itv` ParkScene run,
    `train_LD_37.py:393-412`): streaming inference over one sequence with
    the model's config and the expected mask, on ``device``, then Y/crop4
    PSNR/SSIM against the GT PNG tree. ``eval_fn(state, epoch)`` scores the
    weights the last step wrote: the trained model's (under bfloat16 its
    float32 masters as the model casts them) copied in place into the
    eval model, which bumps their versions, so no stale kernel weight pack
    is reused (``cuda_build.cached_pack``)."""
    from ..data.io import load_eval_sequence, read_gray
    from ..infer.pipeline import StreamingInferencer
    from ..metrics.psnr_ssim import calculate_psnr, calculate_ssim

    data = load_eval_sequence(lr_dir, side_dir, max_frames)
    eval_model = CVSRV8(dataclasses.replace(model_cfg, mask_mode="expected"),
                        torch.Generator().manual_seed(0), device=device)
    inf = StreamingInferencer(eval_model)

    def eval_fn(state: TrainState, epoch: int) -> dict:
        eval_model.load_state_dict(state.model.state_dict())
        frames, _ = inf.run_sequence(data)
        psnrs, ssims = [], []
        for i, f in enumerate(frames):
            gt = read_gray(os.path.join(gt_dir, "%05d.png" % i))
            mh, mw = min(gt.shape[0], f.shape[0]), min(gt.shape[1], f.shape[1])
            a = f[:mh, :mw, None].astype(np.float64)
            b = gt[:mh, :mw, None].astype(np.float64)
            psnrs.append(calculate_psnr(a, b, 4, test_y_channel=True))
            ssims.append(calculate_ssim(a, b, 4, test_y_channel=True))
        metrics = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
        print(json.dumps({"epoch": epoch, **metrics}), flush=True)
        return metrics

    return eval_fn


def run_dirs(train_cfg: TrainConfig, data_cfg: DataConfig) -> tuple[str, str]:
    """(checkpoint directory, JSONL log path) of a run, as ``cdfo_tpu``
    lays them out: ``<ckpt_dir>/<cfg>_<qp>/ckpt`` and
    ``<ckpt_dir>/<cfg>_<qp>/training_log.jsonl``."""
    run = os.path.join(train_cfg.ckpt_dir,
                       f"{data_cfg.coding_cfg}_{data_cfg.qp}")
    return os.path.join(run, "ckpt"), os.path.join(run, "training_log.jsonl")


def train_loop(model_cfg: ModelConfig, data_cfg: DataConfig,
               train_cfg: TrainConfig, data_root: str,
               num_epochs: Optional[int] = None,
               steps_per_epoch: Optional[int] = None,
               log_dir: Optional[str] = None,
               eval_fn: Optional[Callable] = None,
               cache_path: Optional[str] = None,
               device: torch.device | str = "cuda",
               on_start: Optional[Callable] = None,
               on_step: Optional[Callable] = None,
               host_id: int = 0, num_hosts: int = 1) -> TrainState:
    """Trains CVSR_V8 (or an ablation of it: ``model_cfg``) on the CVCP
    tree at ``data_root`` and returns the final ``TrainState``; resumes
    from the newest checkpoint of the run's directory. The model is built
    on ``device`` (the card unless the caller asks for the CPU) from
    ``train_cfg.seed``; under ``mask_mode="sample"`` its gumbel noise comes
    from a generator on that device seeded likewise. ``on_start(state)``,
    if given, is called once before the first step (after a resume),
    ``on_step(state, loss)`` after each step (the loss a device scalar).
    ``eval_fn(state, epoch)``, if given (``make_eval_fn``), runs after each
    checkpoint. ``host_id`` / ``num_hosts``: this rank and the world size
    of the process group, which a data-parallel run must pass
    (``parallel.initialize_distributed`` returns them)."""
    if log_dir is not None:
        raise NotImplementedError(
            "TensorBoard scalars are not ported; the loop writes its JSONL "
            "log (run_dirs) instead")
    group = ((dist.get_rank(), dist.get_world_size())
             if dist.is_initialized() else (0, 1))
    if (host_id, num_hosts) != group:
        raise ValueError(f"host_id={host_id}, num_hosts={num_hosts}: the "
                         f"process group has rank {group[0]} of {group[1]}")
    lead = host_id == 0
    device = torch.device(device)
    model = CVSRV8(model_cfg, torch.Generator().manual_seed(train_cfg.seed),
                   device=device)
    ds = CVCPDataset(data_root, data_cfg, cache_path=cache_path,
                     host_id=host_id, num_hosts=num_hosts)
    batcher = TrainBatcher(ds, train_cfg.batch_size, data_cfg.crop_size,
                           seed=train_cfg.seed)
    spe = steps_per_epoch or max(1, len(ds) // train_cfg.batch_size)
    if dist.is_initialized():
        # every rank takes the same steps: the smallest shard's count
        count = torch.tensor([spe], device=device)
        dist.all_reduce(count, op=dist.ReduceOp.MIN)
        spe = int(count.item())
    state = TrainState(model, train_cfg, steps_per_epoch=spe)
    epochs = num_epochs or train_cfg.epochs
    generator = torch.Generator(device=device).manual_seed(train_cfg.seed)

    ckpt_dir, log_path = run_dirs(train_cfg, data_cfg)
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
    latest = latest_checkpoint(ckpt_dir)
    if latest:
        restore_checkpoint(latest, state, generator)
        if lead:
            print(f"resumed from {latest} at step {state.step}", flush=True)

    if on_start is not None:
        on_start(state)
    it = batcher.prefetch()
    start_epoch = state.step // spe
    for epoch in range(start_epoch, epochs):
        losses = []
        t0 = time.time()
        for _ in range(spe):
            loss = train_step(state, next(it), generator)
            losses.append(loss)
            if on_step is not None:
                on_step(state, loss)
        avg = float(np.mean([float(v) for v in losses]))
        msg = {"epoch": epoch + 1, "loss": round(avg, 5),
               "sec_per_epoch": round(time.time() - t0, 2)}
        if lead:
            print(json.dumps(msg), flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(msg) + "\n")
        if (epoch + 1) % train_cfg.val_interval == 0:
            if lead:
                save_checkpoint(ckpt_dir, state, generator)
            if state.data_parallel:
                dist.barrier()
            if lead and eval_fn is not None:
                eval_fn(state, epoch + 1)
    return state
