"""Full JCT-VC evaluation of the port (the repository's
``tools/eval_jctvc.py``; `test_LD_37.py:237-263` semantics): the 10 LD-QP37
sequences, sliding-window inference with the recurrent cache
(``infer.pipeline.StreamingInferencer``), SR PNGs written per sequence,
then Y/crop4 PSNR/SSIM (and tOF with ``--tof``, which needs ``cv2``)
against the GT trees, one JSON line per sequence and a mean line appended
to the log. On the card unless ``--cpu`` is given:

    python -m cdfo_tpu_torch.tools.eval_jctvc --test-root ./test_data \\
        --ckpt LD_QP37_J_epoch-9500.pth --qp 37 --cfg LD --out results_evl \\
        --log log/LD_ours.txt --bf16 --fused fused_trunk fused_embed \\
        fused_align fused_egla

``--test-root`` holds ``<cfg>/qp<QP>/lr_grey/<seq>``,
``<cfg>/qp<QP>/sideInfo_QP<QP>/<seq without .yuv>`` and ``gt_Y/<gt seq>``;
``write_synthetic_tree`` writes such a tree. ``--ckpt``, ``--bf16`` and
``--fused`` as in ``test_sr``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..data.io import load_eval_sequence, write_gray
from ..infer.pipeline import StreamingInferencer
from ..metrics.psnr_ssim import cal_psnr_ssim, cal_psnr_ssim_tof
from ..models import CVSRV8
from .test_sr import add_model_flags, load_weights, model_config

# `test_LD_37.py:238-261`
SEQUENCES = [
    ("BasketballDrive_fps50_480x272_500F.yuv", "BasketballDrive_1920x1080_50_500F.yuv"),
    ("Kimono1_fps24_480x272_240F.yuv", "Kimono1_1920x1080_24_240F.yuv"),
    ("BQTerrace_fps60_480x272_600F.yuv", "BQTerrace_1920x1080_60_600F.yuv"),
    ("ParkScene_fps24_480x272_240F.yuv", "ParkScene_1920x1080_24_240F.yuv"),
    ("Traffic_640x400_300F.yuv", "Traffic_2560x1600_30.yuv"),
    ("PeopleOnStreet_640x400_150F.yuv", "PeopleOnStreet_2560x1600_30.yuv"),
    ("KristenAndSara_320x184_600F.yuv", "KristenAndSara_1280x720_60.yuv"),
    ("Johnny_320x184_600F.yuv", "Johnny_1280x720_60.yuv"),
    ("FourPeople_320x184_600F.yuv", "FourPeople_1280x720_60.yuv"),
    ("Cactus_480x272_500F.yuv", "Cactus_1920x1080_50.yuv"),
]


def lr_size(seq: str) -> tuple[int, int]:
    """(H, W) of an LR sequence from its name's ``_<W>x<H>_``."""
    w, h = re.search(r"_(\d+)x(\d+)_", seq).groups()
    return int(h), int(w)


def evaluate_jctvc(cfg: ModelConfig, test_root: str, device,
                   ckpt: str = "", qp: int = 37, coding_cfg: str = "LD",
                   out: str = "results_evl", log: str = "log/eval_jctvc.txt",
                   max_frames: int = 0,
                   sequences: Optional[Sequence[str]] = None,
                   tof: bool = False, fps: bool = False,
                   echo: Callable = print) -> list[dict]:
    """The sequences of ``SEQUENCES`` (those named in ``sequences``, if
    given) through one CVSR_V8 of ``cfg`` on ``device`` (seeded weights, or
    ``ckpt``'s); returns the per-sequence entries, each also printed and
    appended to ``log``, as is the mean line."""
    lr_root = os.path.join(test_root, coding_cfg, f"qp{qp}", "lr_grey")
    side_root = os.path.join(test_root, coding_cfg, f"qp{qp}",
                             f"sideInfo_QP{qp}")
    gt_root = os.path.join(test_root, "gt_Y")
    model = CVSRV8(cfg, torch.Generator().manual_seed(0), device=device)
    if ckpt:
        load_weights(model, ckpt)
    os.makedirs(os.path.dirname(log) or ".", exist_ok=True)
    seqs = [s for s in SEQUENCES if not sequences or s[0] in set(sequences)]
    run_dir = os.path.join(out, f"{coding_cfg}_QP{qp}")
    results = []
    for seq, gt in seqs:
        data = load_eval_sequence(os.path.join(lr_root, seq),
                                  os.path.join(side_root, seq[:-4]),
                                  max_frames or None)
        frames, rate = StreamingInferencer(model).run_sequence(
            data, collect_timing=fps)
        for i, f in enumerate(frames):
            write_gray(os.path.join(run_dir, seq, "%05d.png" % i), f)
        nf = len(frames)
        if tof:
            _, psnr, ssim, tof_v = cal_psnr_ssim_tof(
                run_dir + "/", [seq], [gt], gt_root + "/", num_frames=nf)[0]
            entry = {"seq": seq, "psnr": round(psnr, 3),
                     "ssim": round(ssim, 5), "tof": round(tof_v, 4)}
        else:
            psnr, ssim = cal_psnr_ssim(run_dir + "/", [seq], [gt],
                                       gt_root + "/", num_frames=nf)
            entry = {"seq": seq, "psnr": round(psnr, 3),
                     "ssim": round(ssim, 5)}
        if rate:
            entry["fps"] = round(rate, 3)
        results.append(entry)
        with open(log, "a") as f:
            f.write(json.dumps(entry) + "\n")
        echo(json.dumps(entry))

    if results:
        mean = {"psnr": round(float(np.mean([r["psnr"] for r in results])), 3),
                "ssim": round(float(np.mean([r["ssim"] for r in results])), 5)}
        echo(json.dumps({"mean": mean, "sequences": len(results)}))
        with open(log, "a") as f:
            f.write(json.dumps({"mean": mean}) + "\n")
    return results


def write_synthetic_tree(root: str, sequences: Sequence[str], frames: int,
                         qp: int = 37, coding_cfg: str = "LD", seed: int = 0,
                         size: Optional[tuple[int, int]] = None) -> None:
    """A seeded noise tree in ``evaluate_jctvc``'s layout for the named
    sequences of ``SEQUENCES``, ``frames`` frames each at the LR (H, W)
    the name gives, or ``size`` (GT at 4x), with random motion vectors."""
    r = np.random.RandomState(seed)
    gts = dict(SEQUENCES)
    for seq in sequences:
        h, w = size or lr_size(seq)
        lr_dir = os.path.join(root, coding_cfg, f"qp{qp}", "lr_grey", seq)
        side = os.path.join(root, coding_cfg, f"qp{qp}", f"sideInfo_QP{qp}",
                            seq[:-4])
        gt_dir = os.path.join(root, "gt_Y", gts[seq])
        for d in ("res", "mvl0", "mvl1"):
            os.makedirs(os.path.join(side, d), exist_ok=True)
        for i in range(frames):
            idx, pidx = "%05d" % i, "%05d" % max(1, i)
            write_gray(os.path.join(lr_dir, idx + ".png"),
                       r.randint(0, 255, (h, w), dtype=np.uint8))
            write_gray(os.path.join(gt_dir, idx + ".png"),
                       r.randint(0, 255, (4 * h, 4 * w), dtype=np.uint8))
            write_gray(os.path.join(side, "part_m", pidx + "_M_mask.png"),
                       r.randint(0, 255, (h, w), dtype=np.uint8))
            np.save(os.path.join(side, "res", pidx + "_res.npy"),
                    r.randint(-20, 20, (h, w)).astype(np.int16))
            write_gray(os.path.join(side, "unfiltered", pidx + "_unflt.png"),
                       r.randint(0, 255, (h, w), dtype=np.uint8))
            for d in ("mvl0", "mvl1"):
                mv = np.zeros((h, w, 3), np.int16)
                mv[..., :2] = r.randint(-64, 64, (h, w, 2))
                mv[..., 2] = -1
                np.save(os.path.join(side, d, f"{pidx}_{d}.npy"), mv)


def main(argv=None):
    p = argparse.ArgumentParser(description="cdfo_tpu_torch JCT-VC eval")
    p.add_argument("--test-root", required=True,
                   help="dir with <cfg>/qp<QP>/lr_grey + sideInfo_QP<QP> + gt_Y")
    p.add_argument("--ckpt", default="")
    p.add_argument("--qp", default=37, type=int)
    p.add_argument("--cfg", default="LD")
    p.add_argument("--out", default="results_evl")
    p.add_argument("--log", default="log/eval_jctvc.txt")
    p.add_argument("--max-frames", default=0, type=int)
    p.add_argument("--sequences", nargs="*", default=None,
                   help="subset of sequence names (default: all 10)")
    p.add_argument("--tof", action="store_true")
    p.add_argument("--fps", action="store_true")
    add_model_flags(p)
    args = p.parse_args(argv)
    cfg = model_config(args, mask_mode="expected")
    return evaluate_jctvc(cfg, args.test_root, "cpu" if args.cpu else "cuda",
                          ckpt=args.ckpt, qp=args.qp, coding_cfg=args.cfg,
                          out=args.out, log=args.log,
                          max_frames=args.max_frames,
                          sequences=args.sequences, tof=args.tof,
                          fps=args.fps)


if __name__ == "__main__":
    main()
