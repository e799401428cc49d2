"""Evaluation CLI of the port (the repository's ``tools/test_sr.py``;
`test_LD_37.py` semantics): sliding-window inference over one sequence
(``infer.pipeline.StreamingInferencer``), SR PNGs written out, then
PSNR/SSIM (Y, crop_border=4). On the card unless ``--cpu`` is given:

    python -m cdfo_tpu_torch.tools.test_sr --lr-dir .../lr_grey/Seq.yuv \\
        --side-dir .../sideInfo_QP37/Seq --gt-dir .../gt_Y/Seq \\
        --ckpt training_results/LD_37/ckpt/step_00000200.pt
    python -m cdfo_tpu_torch.tools.test_sr --synthetic --cpu

``--ckpt`` takes the port's ``step_%08d.pt`` or a released CDFO ``.pth``
(``compat.load_reference_checkpoint``). ``--bf16`` and ``--fused`` (any of
the ``ModelConfig`` kernel flags) choose the path on the card.
``--synthetic`` runs a seeded 9-frame 64x96 sequence through a one-group
model. ``--scan-trunk`` runs the trunk's groups as the scan trunk (the same
outputs; it cannot be combined with ``--fused fused_trunk``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable

import numpy as np
import torch

from ..compat import load_reference_checkpoint
from ..config import ModelConfig
from ..data.io import load_eval_sequence, read_gray, write_gray
from ..infer.pipeline import SequenceData, StreamingInferencer, \
    synthetic_sequence
from ..metrics.psnr_ssim import calculate_psnr, calculate_ssim
from ..models import CVSRV8

KERNEL_FLAGS = ("fused_trunk", "fused_embed", "fused_align", "fused_egla",
                "trunk_int8", "block_warp")


def add_model_flags(p: argparse.ArgumentParser) -> None:
    """The flags that choose the model's path: ``--cpu``, ``--bf16``,
    ``--fused`` and ``--scan-trunk``."""
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--fused", nargs="*", default=[], choices=KERNEL_FLAGS,
                   help="ModelConfig kernel flags to switch on")
    p.add_argument("--scan-trunk", action="store_true",
                   help="scan trunk: each group recomputed in a backward "
                        "pass (same outputs)")


def model_config(args, **kw) -> ModelConfig:
    """The ``ModelConfig`` that ``add_model_flags``' flags ask for, with
    ``kw``; exits without a card unless ``--cpu`` is given."""
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("the eval tools run on the card and "
                 "torch.cuda.is_available() is False; pass --cpu to run on "
                 "the CPU")
    return ModelConfig(
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        scan_trunk=args.scan_trunk, **{f: True for f in args.fused}, **kw)


def load_weights(model: CVSRV8, path: str) -> None:
    """The weights of a port checkpoint (``step_%08d.pt``: the trained
    model's ``state_dict``) or of a released CDFO ``.pth`` into ``model``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "masters" in blob and "model" in blob:
        model.load_state_dict(blob["model"])
    else:
        load_reference_checkpoint(model, path)


def frame_scores(frames, gt_dir: str) -> tuple[float, float]:
    """Mean Y/crop-4 PSNR and SSIM of uint8 ``frames`` against the GT PNGs
    ``gt_dir/%05d.png``, each pair cut to their common size."""
    psnrs, ssims = [], []
    for i, f in enumerate(frames):
        gt = read_gray(os.path.join(gt_dir, "%05d.png" % i))
        mh, mw = min(gt.shape[0], f.shape[0]), min(gt.shape[1], f.shape[1])
        a = f[:mh, :mw, None].astype(np.float64)
        b = gt[:mh, :mw, None].astype(np.float64)
        psnrs.append(calculate_psnr(a, b, 4, test_y_channel=True))
        ssims.append(calculate_ssim(a, b, 4, test_y_channel=True))
    return float(np.mean(psnrs)), float(np.mean(ssims))


def evaluate(cfg: ModelConfig, data: SequenceData, device, ckpt: str = "",
             save_dir: str = "results_evl", fps: bool = False,
             dump_features: str = "", gt_dir: str = "",
             log: Callable = print) -> dict:
    """One sequence through a CVSR_V8 of ``cfg`` on ``device`` (seeded
    weights, or ``ckpt``'s): the SR frames written to ``save_dir``, the
    forward-only fps with ``fps``, one window's aligned-feature maps to
    ``dump_features``, PSNR/SSIM against ``gt_dir``. Returns ``frames``
    and, as asked, ``fps``, ``psnr`` and ``ssim``."""
    model = CVSRV8(cfg, torch.Generator().manual_seed(0), device=device)
    if ckpt:
        load_weights(model, ckpt)
    inf = StreamingInferencer(
        model, generator=torch.Generator(device=device).manual_seed(2)
        if cfg.mask_mode == "sample" else None)
    frames, rate = inf.run_sequence(data, collect_timing=fps)
    out = {"frames": frames}

    os.makedirs(save_dir, exist_ok=True)
    for i, f in enumerate(frames):
        write_gray(os.path.join(save_dir, "%05d.png" % i), f)
    log(f"wrote {len(frames)} SR frames to {save_dir}")
    if rate:
        out["fps"] = rate
        log(f"forward-only fps: {rate:.3f}")

    if dump_features:
        # one representative window through the capturing model
        window = inf._build_window(data, min(3, data.num_frames - 1))
        model.capture_features = True
        with torch.inference_mode():
            model(*(torch.from_numpy(a).to(device) for a in window),
                  generator=torch.Generator(device=device).manual_seed(0))
        model.capture_features = False
        f = model.intermediates.pop("aligned_fea")[0].float().cpu().numpy()
        os.makedirs(dump_features, exist_ok=True)
        for n in range(f.shape[0]):
            fmap = f[n].mean(axis=-1)
            fmap = (fmap - fmap.min()) / (np.ptp(fmap) + 1e-8) * 255
            write_gray(os.path.join(dump_features, f"aligned_fea_f{n}.png"),
                       fmap.astype(np.uint8))
        log(f"dumped {f.shape[0]} aligned-feature maps to {dump_features}")

    if gt_dir:
        out["psnr"], out["ssim"] = frame_scores(frames, gt_dir)
        log(f"PSNR {out['psnr']:.3f}  SSIM {out['ssim']:.5f}")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cdfo_tpu_torch eval")
    p.add_argument("--lr-dir", default="")
    p.add_argument("--side-dir", default="")
    p.add_argument("--gt-dir", default="")
    p.add_argument("--ckpt", default="")
    p.add_argument("--save-dir", default="results_evl")
    p.add_argument("--max-frames", default=0, type=int)
    p.add_argument("--fps", action="store_true", help="report forward-only fps")
    p.add_argument("--mask-mode", default="expected",
                   choices=["expected", "sample"])
    p.add_argument("--dump-features", default="",
                   help="directory to save aligned-feature maps (the "
                        "reference's featuremap_visual, behind a flag)")
    p.add_argument("--synthetic", action="store_true")
    add_model_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = model_config(args, mask_mode=args.mask_mode)
    if args.synthetic:
        data = synthetic_sequence(t=9, h=64, w=96)
        cfg = dataclasses.replace(cfg, scn_groups=1)
    else:
        data = load_eval_sequence(args.lr_dir, args.side_dir,
                                  args.max_frames or None)
    return evaluate(cfg, data, "cpu" if args.cpu else "cuda", ckpt=args.ckpt,
                    save_dir=args.save_dir, fps=args.fps,
                    dump_features=args.dump_features, gt_dir=args.gt_dir)


if __name__ == "__main__":
    main()
