"""Small-copy throughput probe on the GPU, the port of
``tools/microbench_dma.py``: how fast do many small strided patch copies
into shared memory run with many in flight (TMA tensor copies, one a patch,
a ring of stages per CTA and several CTAs an SM), against one big
contiguous copy? It sizes the block warp's patch gathers.

  mode=patch : N copies of (8, 6*C) strided rows (the TPU tool's smallest
               tile-legal block-gather unit)
  mode=run16 : N/16 copies of (8, 66*C) (a merged run of 16 blocks; 2 in
               flight a CTA, one CTA an SM)
  mode=row   : N copies of (8, 4*C)
  mode=big   : one contiguous copy of about the same bytes

Each mode first holds the kernel's checksum against its plain version
(``ops/kernel_cases.py``), then times a chain of ``--reps`` calls and one
of twice as many and reports their difference per call, as the TPU tool
does. Each chain is captured in a CUDA graph and timed by its replays
(best of 3, CUDA events): a call's device work is shorter than the
wrapper's host work, which would otherwise set the time. The wrappers'
``launches`` count the kernels of every replay. The ring, (H+8, (W+8)*C)
bf16, is 17.5 MB at the defaults and stays in the card's 50 MB L2 between
calls, so these are L2 rates (the TPU tool's ring sits in HBM).

    python -m cdfo_tpu_torch.tools.microbench_dma [--nblocks 8160] [--c 64]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import kernel_cases as kc
from ..ops import probe_dma as pm
from . import captured, event_ms, require_card


@torch.no_grad()
def main(argv=None) -> dict:
    """Prints the TPU tool's line per mode; returns {mode: (seconds per
    call, GB/s)}."""
    p = argparse.ArgumentParser()
    p.add_argument("--h", type=int, default=272)
    p.add_argument("--w", type=int, default=480)
    p.add_argument("--c", type=int, default=64)
    p.add_argument("--nblocks", type=int, default=68 * 120,
                   help="patch copies per call (one 272x480 frame = 8160)")
    p.add_argument("--modes", default="patch,row,big")
    p.add_argument("--reps", type=int, default=8)
    args = p.parse_args(argv)
    card = require_card("microbench_dma")
    h, w, c, nblk = args.h, args.w, args.c, args.nblocks
    rng = np.random.RandomState(0)
    ring = torch.from_numpy(rng.randn(h + 8, (w + 8) * c).astype(
        np.float32)).to("cuda", torch.bfloat16)
    print(f"microbench_dma ring {tuple(ring.shape)} bf16 "
          f"({ring.numel() * 2 / 1e6:.1f} MB) on {card}", flush=True)

    results = {}
    for mode in args.modes.split(","):
        pw = pm.PATCHES.get(mode, (8, 6))[1]
        starts = torch.from_numpy(pm.mk_starts(rng, h, w, c, nblk, pw)).cuda()
        if mode in pm.PATCHES:
            ph = pm.PATCHES[mode][0]
            nb = nblk // 16 if mode == "run16" else nblk
            st = starts[:2 * nb].contiguous()

            def call(st=st, ph=ph, pw=pw):
                return pm.gather(ring, st, ph, pw * c)

            ref = pm.gather_plain(ring, st, ph, pw * c)
            nbytes = nb * ph * pw * c * 2
            kind = "gather"
        else:
            rows = pm.big_rows(h, w, nblk)

            def call(rows=rows):
                return pm.big(ring, starts, rows)

            ref = pm.big_plain(ring, starts, rows)
            nb, nbytes, kind = 1, rows * (w + 8) * c * 2, "big"
        kc.assert_outputs_close(call(), ref, torch.bfloat16, kind)

        def chain(reps):
            for _ in range(reps):
                call()

        times = {reps: min(event_ms(captured(lambda n=reps: chain(n),
                                             pm.gather, pm.big), 3)) / 1e3
                 for reps in (args.reps, 2 * args.reps)}
        dt = (times[2 * args.reps] - times[args.reps]) / args.reps
        results[mode] = (dt, nbytes / dt / 1e9)
        if kind == "gather":
            print(f"{mode}: {dt * 1e3:.3f} ms/call  {dt / nb * 1e9:.1f} "
                  f"ns/copy  {nbytes / dt / 1e9:.1f} GB/s  ({nb} copies, "
                  f"{nbytes // nb} B each)", flush=True)
        else:
            print(f"{mode}: {dt * 1e3:.3f} ms/call  {nbytes / dt / 1e9:.1f} "
                  f"GB/s  ({nbytes / 1e6:.1f} MB contiguous)", flush=True)
    return results


if __name__ == "__main__":
    main()
