"""Training CLI of the port (``tools/train.py`` of the JAX package: the
reference's ``train_LD_37.py`` / ``train_RA_37.py`` unified), on the card
unless ``--cpu`` is given:

    python -m cdfo_tpu_torch.tools.train --cfg LD --qp 37 --data-root /data/CVCP
    python -m cdfo_tpu_torch.tools.train --synthetic --epochs 1 \\
        --steps-per-epoch 2 --fused-trunk --bf16
    python -m cdfo_tpu_torch.tools.train --synthetic --cpu --epochs 1 \\
        --steps-per-epoch 1

Checkpoints and the JSONL log go under ``--ckpt-dir``
(``<cfg>_<qp>/ckpt/step_%08d.pt``, ``<cfg>_<qp>/training_log.jsonl``); a
second run with the same directory resumes from the newest checkpoint.
``--synthetic`` writes a small noise tree to a temporary directory (2
sequences of 10 frames at 64x64) and trains a one-group model on batches
of 2, as the JAX tool does. The model trains with the sampled EGLA mask.
``--eval-lr-dir``, ``--eval-side-dir`` and ``--eval-gt-dir`` name one eval
sequence (``data/io.py``'s eval layout and its GT PNGs) that is scored after
every checkpoint (``train/loop.py::make_eval_fn``). ``--scan-trunk`` and
``--distributed`` raise: their work is not ported.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cdfo_tpu_torch trainer")
    p.add_argument("--cfg", default="LD", choices=["LD", "RA"])
    p.add_argument("--qp", default=37, type=int)
    p.add_argument("--data-root", default="")
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--epochs", default=30000, type=int)
    p.add_argument("--batch-size", default=0, type=int, help="0 = preset")
    p.add_argument("--val-itv", default=0, type=int, help="0 = preset")
    p.add_argument("--weight-decay", default=1e-5, type=float)
    p.add_argument("--seed", default=4, type=int)
    p.add_argument("--ckpt-dir", default="training_results")
    p.add_argument("--cache", default="", help="per-array .npy cache dir")
    p.add_argument("--steps-per-epoch", default=0, type=int)
    p.add_argument("--synthetic", action="store_true",
                   help="generate + train on a tiny synthetic CVCP tree")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host data parallelism (not ported)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--fused-trunk", action="store_true",
                   help="train through the hand-written trunk and head "
                        "kernels (recompute backwards, ops/fused_vjp.py)")
    p.add_argument("--scan-trunk", action="store_true",
                   help="scan-over-groups trunk (not ported)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, float32 master weights and loss")
    p.add_argument("--eval-lr-dir", default="",
                   help="validation sequence LR dir (periodic eval)")
    p.add_argument("--eval-side-dir", default="")
    p.add_argument("--eval-gt-dir", default="")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.scan_trunk:
        raise NotImplementedError("--scan-trunk waits for the scan trunk "
                                  "(ROADMAP Queue 1, item 1.6)")
    if args.distributed:
        raise NotImplementedError("--distributed waits for data-parallel "
                                  "training (ROADMAP Queue 1, item 1.8)")
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("cdfo_tpu_torch.tools.train runs on the card and "
                 "torch.cuda.is_available() is False; pass --cpu to train "
                 "on the CPU")

    from ..config import DataConfig, ModelConfig, TrainConfig
    from ..data.io import make_synthetic_cvcp_tree
    from ..train.loop import make_eval_fn, train_loop

    is_ra = args.cfg == "RA"
    data_cfg = DataConfig(coding_cfg=args.cfg, qp=args.qp,
                          zero_mvl1_in_train=not is_ra)
    train_cfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay,
        batch_size=args.batch_size or (24 if is_ra else 20),
        epochs=args.epochs,
        val_interval=args.val_itv or (400 if is_ra else 200),
        seed=args.seed, ckpt_dir=args.ckpt_dir)
    mkw = dict(mask_mode="sample", fused_trunk=args.fused_trunk,
               compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    model_cfg = ModelConfig(**mkw)
    data_root, spe, synthetic_root = args.data_root, args.steps_per_epoch, None
    if args.synthetic:
        synthetic_root = data_root = tempfile.mkdtemp(prefix="cvcp_synth_")
        make_synthetic_cvcp_tree(data_root, num_seqs=2, frames=10, h=64,
                                 w=64, qp=args.qp, cfg=args.cfg)
        data_cfg = DataConfig(coding_cfg=args.cfg, qp=args.qp,
                              frames_per_seq=10, zero_mvl1_in_train=not is_ra)
        train_cfg = TrainConfig(batch_size=2, epochs=args.epochs,
                                val_interval=max(1, args.epochs),
                                ckpt_dir=args.ckpt_dir, seed=args.seed)
        model_cfg = ModelConfig(scn_groups=1, **mkw)
        spe = spe or 2
    device = "cpu" if args.cpu else "cuda"
    eval_fn = None
    if args.eval_lr_dir:
        eval_fn = make_eval_fn(model_cfg, args.eval_lr_dir,
                               args.eval_side_dir, args.eval_gt_dir,
                               device=device)
    try:
        return train_loop(model_cfg, data_cfg, train_cfg, data_root,
                          steps_per_epoch=spe or None,
                          cache_path=args.cache or None, eval_fn=eval_fn,
                          device=device)
    finally:
        if synthetic_root:
            shutil.rmtree(synthetic_root, ignore_errors=True)


if __name__ == "__main__":
    main()
