"""Parameters and forward FLOPs of a registry model (the port of
``tools/flops.py``)::

    python -m cdfo_tpu_torch.tools.flops --model cvsr_v8 --hw 272 480 [--cpu]

Builds ``build_model(name)`` without kernel flags (a hand-written kernel is
opaque to the counter) with the noise-free mask, runs one forward on a
7-frame clip (seeded random inputs) and prints its parameter count and
GFLOP as ``torch.utils.flop_counter.FlopCounterMode`` counts them: matrix
products and convolutions only. ``cdfo_tpu``'s tool reports XLA's cost
analysis, which counts every operation; the two numbers are different
measures. Runs on the card unless ``--cpu`` is given; without CUDA and
without ``--cpu`` it exits non-zero. The last line is a JSON object with
``model``, ``hw``, ``params`` and ``gflop``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import MODEL_NAMES, ModelConfig
from ..models import build_model
from ..utils import count_params, estimate_flops


def model_inputs(name: str, h: int, w: int, device, nframes: int = 7):
    """A seeded clip for ``name``'s forward: (lrs, mvs0, mvs1, pms, rms,
    ufs), SIDECVSR's (lrs, mvs, pms, rms, ufs)."""
    r = np.random.RandomState(0)
    xs = (r.rand(1, nframes, h, w, 1), r.randn(1, nframes, h, w, 2),
          r.randn(1, nframes, h, w, 2), r.rand(1, nframes, h, w, 1),
          r.rand(1, nframes, h, w, 1), r.rand(1, nframes, h, w, 1))
    if name == "sidecvsr":
        xs = xs[:2] + xs[3:]
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in xs)


def count(name: str, h: int, w: int, device="cuda",
          cfg: ModelConfig | None = None) -> dict:
    """``{"model", "hw", "params", "gflop"}`` of one forward of ``name`` at
    ``h`` x ``w`` on ``device``."""
    cfg = cfg or ModelConfig(name=name, mask_mode="expected")
    model = build_model(name, cfg, device=device).eval()
    xs = model_inputs(name, h, w, device, cfg.nframes)
    flops = estimate_flops(lambda *a: model(*a), *xs)
    return {"model": name, "hw": [h, w], "params": count_params(model),
            "gflop": flops / 1e9}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="cvsr_v8", choices=MODEL_NAMES)
    p.add_argument("--hw", nargs=2, type=int, default=[64, 96])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("tools.flops runs on the card and torch.cuda.is_available() "
                 "is False; pass --cpu to run on the CPU")
    h, w = args.hw
    out = count(args.model, h, w, "cpu" if args.cpu else "cuda")
    print(f"params: {out['params']:,}")
    print(f"forward GFLOP @ {h}x{w}: {out['gflop']:.2f} (FlopCounterMode: "
          "products and convolutions only)")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
