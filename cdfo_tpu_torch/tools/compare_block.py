"""The exact ``Block_`` kernel of this checkout against another checkout's
(for example the parent commit, unpacked with ``git archive``), in turns on
one card, in bfloat16.

Each side is its own ``ops/fused_block2`` module, built by its own
``cuda_build`` from its own ``csrc/``, and is first held against this
checkout's plain version (``ops/kernel_cases.py``'s tolerance). Then, in
the order other, this, this, other, each side is timed (median of
``--reps`` calls, CUDA events) three ways: the call with its weights
packed in it (``scale_block`` without ``packed``: what a caller that keeps
no pack pays), the call with the pack kept (what the fused trunk pays),
and the pack alone. Times are per call, in ms, with the card's name.

    python -m cdfo_tpu_torch.tools.compare_block --other DIR
        [--b 4 --h 272 --w 480 --reps 15]
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import fused_block2 as fb
from ..ops import kernel_cases as kc
from . import event_ms, require_card

WAYS = ("packed in the call", "pack kept", "pack alone")


def other_block(root: Path):
    """``ops.fused_block2`` of the checkout at ``root``, imported as a
    package of its own so that it builds and loads its own kernel."""
    name = "cdfo_tpu_torch_other"
    init = root / "cdfo_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    package = importlib.util.module_from_spec(spec)
    sys.modules[name] = package
    spec.loader.exec_module(package)
    return importlib.import_module(f"{name}.ops.fused_block2")


def ways(module, args):
    """{way: fn()} of ``WAYS`` for one side."""
    x, *params = args
    packed = module.pack_weights(*params, x.dtype)
    return {WAYS[0]: lambda: module.scale_block(*args),
            WAYS[1]: lambda: module.scale_block(*args, packed=packed),
            WAYS[2]: lambda: module.pack_weights(*params, x.dtype)}


@torch.no_grad()
def main(argv=None):
    require_card("compare_block")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", type=Path, required=True,
                   help="root of the other checkout")
    p.add_argument("--b", type=int, default=4)
    p.add_argument("--h", type=int, default=272)
    p.add_argument("--w", type=int, default=480)
    p.add_argument("--reps", type=int, default=15)
    a = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(1)
    args = kc.trunk_args("block", torch.bfloat16, g, (a.b, a.h, a.w, 64))
    sides = {"other": ways(other_block(a.other.resolve()), args),
             "this": ways(fb, args)}
    ref = fb.scale_block_plain(*args)
    for side, fns in sides.items():
        for way in WAYS[:2]:
            err, scale = kc.worst_error(fns[way](), ref, "block")
            print(f"{side}, {way}: against plain rel {err / scale:.3e} "
                  f"(tolerance {kc.tolerance(torch.bfloat16, 'block'):.1e})",
                  flush=True)
            if not err <= kc.tolerance(torch.bfloat16, "block") * scale:
                raise AssertionError(f"{side} disagrees with plain")
    ms = {(side, way): [] for side in sides for way in WAYS}
    for side in ("other", "this", "this", "other"):
        for way, fn in sides[side].items():
            ms[side, way].append(
                float(np.median(event_ms(fn, a.reps, warmup=3))))
    print(f"exact Block_ {(a.b, a.h, a.w, 64)} bf16, ms a call in turns "
          f"(other, this, this, other) [{card}]:")
    for way in WAYS:
        o, t = ms["other", way], ms["this", way]
        print(f"  {way:20s} other {o[0]:.3f} {o[1]:.3f}, this {t[0]:.3f} "
              f"{t[1]:.3f}: this / other {np.mean(t) / np.mean(o):.4f}",
              flush=True)


if __name__ == "__main__":
    main()
