"""The eval variance of the EGLA gumbel mask (the port of the repository's
``tools/gumbel_variance.py``), on the card unless ``--cpu`` is given:

    python -m cdfo_tpu_torch.tools.gumbel_variance [--steps 300] [--seeds 8]

The reference's EGLA draws gumbel noise even at eval time
(`arch/SIDECVSR_our.py:2168-2177`), so two eval runs of one checkpoint
differ. This trains a small CVSR_V8 with the sampled mask on structured
video (``tools/structured.py``) until it super-resolves, then measures the
PSNR with the expected mask and with the sampled one under ``--seeds``
generators: the numbers behind the eval default (expected).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import ModelConfig
from . import structured


def run(cfg: ModelConfig, steps: int, seeds: int, device, log=print) -> dict:
    """Trains ``cfg`` (the sampled mask; its gumbel noise from a generator
    seeded 1 on ``device``); returns the expected-mask PSNR (``expected``)
    and the sampled one's under generators seeded 0 .. seeds - 1
    (``samples``)."""
    noise = torch.Generator(device=device).manual_seed(1)
    trained = structured.train(cfg, steps, device, generator=noise, log=log)
    expected = structured.eval_psnr(structured.eval_model(
        trained, mask_mode="expected"))
    samples = [structured.eval_psnr(
        trained, generator=torch.Generator(device=device).manual_seed(k))
        for k in range(seeds)]
    log(f"expected-mode PSNR: {expected:.4f} dB")
    log(f"sample-mode  PSNR: mean {np.mean(samples):.4f} dB, "
        f"std {np.std(samples):.4f} dB, "
        f"range [{min(samples):.4f}, {max(samples):.4f}] over "
        f"{seeds} seeds")
    log(f"expected-vs-sample-mean delta: "
        f"{expected - np.mean(samples):+.4f} dB")
    return {"expected": expected, "samples": samples}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--scn-groups", type=int, default=2)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("gumbel_variance runs on the card and "
                 "torch.cuda.is_available() is False; pass --cpu to run on "
                 "the CPU")
    return run(ModelConfig(scn_groups=args.scn_groups, mask_mode="sample"),
               args.steps, args.seeds, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
