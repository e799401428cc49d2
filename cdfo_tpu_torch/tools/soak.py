"""Training-convergence soak at the reference recipe (the JAX package's
``tools/soak.py``), on the card unless ``--cpu`` is given:

    python -m cdfo_tpu_torch.tools.soak --out results_evl/soak \\
        [--root DIR] [--steps 2400] [--kill-after SECONDS]

On a structured synthetic mini-CVCP tree (learnable content:
``make_synthetic_cvcp_tree(structured=True)``, 8 sequences of 32 96x96
frames, written to ``--root`` if it holds none, and a separately seeded
one-sequence ``<root>_eval`` tree the trainer never sees):

1. a training subprocess (``--phase train``: full-depth CVSR_V8 with the
   fused trunk, batch 20 of 7-frame 64x64 crops from the native batcher,
   bf16 with float32 masters, the sampled mask, Adam 1e-4 / wd 1e-5,
   Charbonnier (sum), seed 4, 50 steps an epoch, a checkpoint and an eval
   every 5 epochs) is SIGKILLed after ``--kill-after`` seconds;
2. the same command runs again: ``train_loop`` resumes from the newest
   checkpoint and runs to ``--steps``;
3. the newest checkpoint (the last multiple of 250 steps: 2250 of 2400)
   is restored twice and compared bit for bit, and the PSNR of one eval
   window (``eval_psnr``) must beat MATLAB bicubic x4 by 0.5 dB.

``training_log.jsonl``, ``eval_log.jsonl`` and ``summary.json`` land in
``--out``; the summary line is printed last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..config import DataConfig, ModelConfig, TrainConfig
from ..data.dataset import CVCPDataset
from ..data.io import make_synthetic_cvcp_tree
from ..metrics.matlab import imresize
from ..metrics.psnr_ssim import calculate_psnr
from ..models import CVSRV8
from ..train.loop import (latest_checkpoint, restore_checkpoint, run_dirs,
                          train_loop)
from ..train.state import TrainState

STEPS_PER_EPOCH = 50
VAL_INTERVAL = 5
SEED = 4
# the window eval_psnr scores: frames 20 .. 26 of the eval tree's sequence
EVAL_FRAME0 = 20
MARGIN_DB = 0.5


def recipe() -> tuple[ModelConfig, DataConfig]:
    model_cfg = ModelConfig(mask_mode="sample", fused_trunk=True,
                            compute_dtype=torch.bfloat16)
    return model_cfg, DataConfig(coding_cfg="LD", qp=37, frames_per_seq=32)


def train_config(out: str, steps: int) -> TrainConfig:
    return TrainConfig(batch_size=20, epochs=steps // STEPS_PER_EPOCH,
                       val_interval=VAL_INTERVAL, seed=SEED,
                       ckpt_dir=os.path.join(out, "train"))


def eval_psnr(model: CVSRV8, ds, frame0: int = EVAL_FRAME0
              ) -> tuple[float, float]:
    """PSNR (crop 4) of ``model`` on one 7-frame window of ``ds``'s first
    sequence (frames ``frame0`` ..; zero MVs), against the window's HR
    centre frame, and of MATLAB bicubic x4 of the LR centre frame."""
    n = 7
    lrs = ds.lr[0, frame0:frame0 + n].astype(np.float32) / 255.0
    hr = ds.hr[0, frame0 + n // 2].astype(np.float32)
    pm = ds.pm[0, frame0:frame0 + n].astype(np.float32) / 255.0
    rm = ds.rm[0, frame0:frame0 + n].astype(np.float32) / 255.0
    uf = ds.uf[0, frame0:frame0 + n].astype(np.float32) / 255.0
    device = next(model.parameters()).device
    zmv = torch.zeros((1, n) + lrs.shape[1:] + (2,), device=device)
    x, p, r, u = (torch.from_numpy(a[None, ..., None]).to(device)
                  for a in (lrs, pm, rm, uf))
    with torch.no_grad():
        sr, _ = model(x, zmv, zmv, p, r, u)
    sr8 = np.clip(sr[0, ..., 0].float().cpu().numpy(), 0, 1) * 255.0
    psnr = calculate_psnr(sr8[..., None], hr[..., None], 4)
    bic = np.clip(imresize(lrs[n // 2], 4.0), 0, 1) * 255.0
    psnr_bic = calculate_psnr(bic[..., None], hr[..., None], 4)
    return float(psnr), float(psnr_bic)


def eval_model(model_cfg: ModelConfig, device: str) -> CVSRV8:
    """The soak's eval model: the training config with the expected mask."""
    return CVSRV8(dataclasses.replace(model_cfg, mask_mode="expected"),
                  torch.Generator().manual_seed(0), device=device)


def phase_train(args) -> None:
    """The training run (resumes from the newest checkpoint)."""
    device = "cpu" if args.cpu else "cuda"
    model_cfg, data_cfg = recipe()
    ds_eval = CVCPDataset(args.root + "_eval", data_cfg)
    scorer = eval_model(model_cfg, device)

    def eval_fn(state, epoch):
        scorer.load_state_dict(state.model.state_dict())
        p, pb = eval_psnr(scorer, ds_eval)
        rec = {"epoch": epoch, "step": state.step, "psnr": round(p, 4),
               "psnr_bicubic": round(pb, 4)}
        print(json.dumps({"eval": rec}), flush=True)
        with open(os.path.join(args.out, "eval_log.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        return {"psnr": p}

    train_loop(model_cfg, data_cfg, train_config(args.out, args.steps),
               args.root, steps_per_epoch=STEPS_PER_EPOCH, eval_fn=eval_fn,
               cache_path=os.path.join(args.root, "_cache"), device=device)


def restored_state(path: str, model_cfg: ModelConfig, out: str, steps: int,
                   device: str) -> TrainState:
    state = TrainState(CVSRV8(model_cfg, torch.Generator().manual_seed(1),
                              device=device),
                       train_config(out, steps),
                       steps_per_epoch=STEPS_PER_EPOCH)
    return restore_checkpoint(path, state)


def verify(args, killed: bool, resumed_from: int | None, times: dict) -> dict:
    """Restores the newest checkpoint twice, compares the two bit for bit
    and scores the eval window; writes and returns the summary."""
    device = "cpu" if args.cpu else "cuda"
    model_cfg, data_cfg = recipe()
    ckpt_dir, log_path = run_dirs(train_config(args.out, args.steps),
                                  data_cfg)
    path = latest_checkpoint(ckpt_dir)
    s1, s2 = (restored_state(path, model_cfg, args.out, args.steps, device)
              for _ in range(2))
    same = (s1.step == s2.step
            and all(torch.equal(a, s2.model.state_dict()[k])
                    for k, a in s1.model.state_dict().items())
            and all(map(torch.equal, s1.masters, s2.masters)))
    scorer = eval_model(model_cfg, device)
    scorer.load_state_dict(s1.model.state_dict())
    psnr, psnr_bic = eval_psnr(scorer, CVCPDataset(args.root + "_eval",
                                                   data_cfg))
    summary = {
        "steps": s1.step, "killed_mid_run": killed,
        "resumed_from_step": resumed_from,
        "final_psnr": round(psnr, 4), "bicubic_psnr": round(psnr_bic, 4),
        "margin_db": round(psnr - psnr_bic, 4),
        "resume_bit_consistent": same, **times,
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu")}
    if os.path.exists(log_path):
        shutil.copy(log_path, os.path.join(args.out, "training_log.jsonl"))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cdfo_tpu_torch training soak")
    p.add_argument("--out", default=os.path.join("results_evl", "soak"))
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "cdfo_soak_tree"))
    p.add_argument("--steps", type=int, default=2400)
    p.add_argument("--kill-after", type=float, default=600.0,
                   help="seconds before SIGKILLing the first training run")
    p.add_argument("--phase", default="orchestrate",
                   choices=["orchestrate", "train"])
    p.add_argument("--cpu", action="store_true",
                   help="train and score on the CPU (plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> dict | None:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("cdfo_tpu_torch.tools.soak runs on the card and "
                 "torch.cuda.is_available() is False; pass --cpu to run on "
                 "the CPU")
    if args.steps % STEPS_PER_EPOCH or \
            args.steps < STEPS_PER_EPOCH * VAL_INTERVAL:
        sys.exit(f"--steps {args.steps}: whole epochs of {STEPS_PER_EPOCH} "
                 f"steps, at least one checkpoint's {VAL_INTERVAL} epochs")
    if args.phase == "train":
        phase_train(args)
        return None

    os.makedirs(args.out, exist_ok=True)
    if not os.path.exists(os.path.join(args.root, "sequences_list.csv")):
        print("building the structured trees ...", flush=True)
        make_synthetic_cvcp_tree(args.root, num_seqs=8, frames=32, h=96,
                                 w=96, qp=37, cfg="LD", structured=True)
        make_synthetic_cvcp_tree(args.root + "_eval", num_seqs=1, frames=32,
                                 h=96, w=96, qp=37, cfg="LD",
                                 structured=True, seed=1234)
    cmd = [sys.executable, "-m", "cdfo_tpu_torch.tools.soak", "--phase",
           "train", "--root", args.root, "--out", args.out, "--steps",
           str(args.steps)] + (["--cpu"] if args.cpu else [])
    package_root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [package_root, os.environ.get("PYTHONPATH")]))}
    ckpt_dir, _ = run_dirs(train_config(args.out, args.steps),
                           recipe()[1])

    t0 = time.time()
    child = subprocess.Popen(cmd, env=env)
    try:
        child.wait(timeout=args.kill_after)
        killed = False
        print("phase 1 finished before the kill: shorten --kill-after",
              flush=True)
    except subprocess.TimeoutExpired:
        child.send_signal(signal.SIGKILL)
        child.wait()
        killed = True
        print(f"phase 1 SIGKILLed after {time.time() - t0:.0f} s", flush=True)
    newest = latest_checkpoint(ckpt_dir)
    resumed_from = (int(os.path.basename(newest)[5:13]) if newest else None)
    t1 = time.time()
    rc = subprocess.call(cmd, env=env)
    if rc != 0:
        raise RuntimeError(f"phase 2 (the resumed run) exited {rc}")
    times = {"phase1_s": round(t1 - t0, 1),
             "phase2_s": round(time.time() - t1, 1)}
    summary = verify(args, killed, resumed_from, times)
    print(json.dumps(summary), flush=True)
    if not summary["resume_bit_consistent"]:
        raise AssertionError("the newest checkpoint restores differently")
    if not summary["final_psnr"] > summary["bicubic_psnr"] + MARGIN_DB:
        raise AssertionError(f"the model does not beat bicubic by "
                             f"{MARGIN_DB} dB: {summary}")
    return summary


if __name__ == "__main__":
    main()
