"""The end-to-end PSNR cost of the int8 trunk (``ModelConfig.trunk_int8``)
on a trained small CVSR_V8 (the port of the repository's
``tools/int8_delta.py``), on the card unless ``--cpu`` is given:

    python -m cdfo_tpu_torch.tools.int8_delta [--steps 300] [--cpu]
        [--init-seed 0]

Trains CVSR_V8 (nf 64, ``--scn-groups`` 2, float32, the expected mask,
the plain trunk) on structured video (``tools/structured.py``), then
evaluates the same weights through three trunks: the plain one, the exact
fused kernels (``fused_trunk``) and the int8 kernel (``fused_trunk`` +
``trunk_int8``). Prints the three PSNRs, the two deltas against the plain
trunk and the int8 trunk's y1 / y2 values past their lagged scale over the
eval windows (which the port quantizes again and the TPU's kernel clips).
Beside them, on the same weights: the TPU's int8 scheme at its kernel's own
steps (``fused_block2_q.tpu_geometry``, clipping; the plain version, on
the CPU), where the CUDA kernel walks 8 x 8 steps, and the same three
trunks with the model in bfloat16 (the kernels of the bfloat16 paths),
each also against the float32 plain trunk, for information.
TF32 is off while it runs, so the plain trunk computes in float32 as the
kernels do. The budget for the int8 trunk is 0.05 dB (``BASELINE.md``).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..config import ModelConfig
from ..ops.fused_block2_q import tpu_geometry
from . import structured

BUDGET_DB = 0.05


def run(cfg: ModelConfig, steps: int, device, log=print, seed: int = 0
        ) -> dict:
    """Trains ``cfg`` (the plain trunk, the expected mask) from weights
    drawn with ``seed`` and evaluates the weights through the three
    trunks. Returns the PSNRs (``plain``, ``exact``, ``int8``), the deltas
    against the plain trunk and the int8 trunk's clip totals (y1 and y2
    values past the lagged scale, all y1 and y2 values); ``tpu_delta`` and
    ``tpu_clips``, the TPU scheme's (its steps, clipping); ``bf16``, the three
    trunks' PSNRs with the model in bfloat16."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        trained = structured.train(cfg, steps, device, log=log, seed=seed)
        plain = structured.eval_psnr(trained)
        exact = structured.eval_psnr(structured.eval_model(
            trained, fused_trunk=True))
        q = structured.eval_model(trained, fused_trunk=True, trunk_int8=True)
        q.recon_trunk.count_clips()
        int8 = structured.eval_psnr(q)
        clips = q.recon_trunk.clip_totals()
        bf16 = {name: structured.eval_psnr(structured.eval_model(
                    trained, compute_dtype=torch.bfloat16, **kw))
                for name, kw in (("plain", {}), ("exact", {"fused_trunk": True}),
                                 ("int8", {"fused_trunk": True,
                                           "trunk_int8": True}))}
        tpu = structured.eval_model(trained.cpu(), fused_trunk=True,
                                    trunk_int8=True)
        tpu.recon_trunk.set_int8_geometry(tpu_geometry(structured.W))
        tpu.recon_trunk.count_clips()
        on_tpu_steps = structured.eval_psnr(tpu)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out = {"plain": plain, "exact": exact, "int8": int8,
           "exact_delta": exact - plain, "int8_delta": int8 - plain,
           "clips": clips, "tpu_delta": on_tpu_steps - plain,
           "tpu_clips": tpu.recon_trunk.clip_totals(), "bf16": bf16}
    log(f"plain trunk PSNR:      {plain:.4f} dB")
    log(f"fused exact PSNR:      {exact:.4f} dB  (delta {exact - plain:+.4f})")
    log(f"int8 trunk PSNR:       {int8:.4f} dB  (delta {int8 - plain:+.4f}, "
        f"budget {BUDGET_DB} dB)")
    log(f"int8 values past the lagged scale over the eval windows "
        f"(quantized again): y1 {clips[0]:.0f} of {clips[2]:.0f} "
        f"({clips[0] / clips[2]:.3e}), y2 {clips[1]:.0f} of {clips[3]:.0f} "
        f"({clips[1] / clips[3]:.3e})")
    tc = out["tpu_clips"]
    log(f"the TPU's int8 scheme (its steps, tpu_geometry({structured.W}), "
        f"clipping; plain version on the CPU): {on_tpu_steps:.4f} dB (delta "
        f"{on_tpu_steps - plain:+.4f}), clipped y1 {tc[0]:.0f}, y2 {tc[1]:.0f}")
    log("bfloat16 model: " + ", ".join(
        f"{k} {v:.4f} dB ({v - plain:+.4f} from the float32 plain)"
        for k, v in bf16.items())
        + f"; int8 - exact {bf16['int8'] - bf16['exact']:+.4f}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--scn-groups", type=int, default=2)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--init-seed", type=int, default=0,
                   help="seed of the model's initial weights")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("int8_delta runs on the card and torch.cuda.is_available() "
                 "is False; pass --cpu to run on the CPU")
    return run(ModelConfig(scn_groups=args.scn_groups), args.steps,
               "cpu" if args.cpu else "cuda", seed=args.init_seed)


if __name__ == "__main__":
    main()
