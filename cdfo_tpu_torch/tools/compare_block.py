"""A kernel of this checkout against another checkout's (for example the
parent commit, unpacked with ``git archive``), in turns on one card, in
bfloat16: the exact ``Block_`` (``--kernel block``), the int8 ``Block_``
(``blockq``), the alignment tail (``tail``, 6 neighbours per image), the
upsample head (``head``), the group tail (``group``), MDTA stage 1 or 2
(``mdta1``, ``mdta2``), dual-MSA stage 1 or 2 (``msa1``, ``msa2``, 6
neighbours per centre, ``--b`` centres), EGLA's eg1 or eg2 (``eg1``,
``eg2``, ``--b`` frames), the ``Block_`` body pair (``body``), the block
warp (``warp``: 6 neighbour images of each of ``--b`` centres from a ring
of 8 frames, flows constant over 4x4 blocks), or a trunk probe at
``chip_smoke.py``'s timed case: the dot probe (``dots``: (256, 192, 516),
2048 reps), the row probes (``rowpipe``, ``kstack``: (256, 64, 516), 1024
reps, 8 rows, their weights split by output channels; ``--split in``: (64,
256, 516), split by input channels over a cluster) or the DMA probe's gather (``gather``: 8160 patches of (8,
384) of the tool's ring, each call timed in a CUDA graph of 16 calls over
16 copies of the ring, so that it reads device memory and no host work
sits between the calls).

Each side is its own ``ops`` module, built by its own ``cuda_build`` from
its own ``csrc/``, and is first held against this checkout's plain version
(``ops/kernel_cases.py``'s tolerance). Then, in the order other, this,
this, other, each side is timed (median of ``--reps`` calls, CUDA events)
three ways: the call with its weights packed in it (the wrapper without
``packed``: what a caller that keeps no pack pays), the call with the pack
kept (what the model pays) and the pack alone; a side whose wrapper takes
no pack (the tail before it had one, the head, the group tail, the MDTA
passes and dual-MSA stage 2 before they had one, eg1, whose matrices change
with the mask, dual-MSA stage 1 and eg2, whose walks read their weights as
they are, the block warp, which has no weights, and the body pair before
it had one) has only the first. Times are per call, in ms, with the card's
name.

    python -m cdfo_tpu_torch.tools.compare_block --other DIR
        [--kernel block|blockq|tail|head|group|mdta1|mdta2|msa1|msa2|eg1|eg2|
                  body|warp|dots|rowpipe|kstack|gather --split out|in --b 4
         --h 272 --w 480 --reps 15]
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import fused_align as fal
from ..ops import fused_block as fbody
from ..ops import fused_block2 as fb
from ..ops import fused_block2_q as fq
from ..ops import fused_egla as fe
from ..ops import fused_groupconv as fg
from ..ops import fused_head as fh
from ..ops import fused_mdta as fm
from ..ops import fused_tail as ft
from ..ops import kernel_cases as kc
from ..ops import probe_dma as pm
from ..ops import probe_dots as pd
from ..ops import warp_block as wb
from . import captured, event_ms, require_card

WAYS = ("packed in the call", "pack kept", "pack alone")
# kind: (module, wrapper, pack(module, args), plain version, what it is)
KERNELS = {
    "block": (fb, "scale_block",
              lambda m, a: m.pack_weights(*a[1:], a[0].dtype),
              fb.scale_block_plain, "exact Block_"),
    "blockq": (fq, "scale_block_q",
               lambda m, a: m.pack_weights_q(*a[1:], a[0].dtype),
               fq.scale_block_q_plain, "int8 Block_"),
    "tail": (ft, "resblock_pair",
             lambda m, a: m.pack_tail_weights(a[3::2], a[4::2], a[0].dtype),
             ft.resblock_pair_plain, "alignment tail"),
    "head": (fh, "fused_head",
             lambda m, a: m.pack_head_weights(*a[2:7], a[0].dtype),
             fh.fused_head_plain, "upsample head"),
    "group": (fg, "grouptail",
              lambda m, a: m.pack_grouptail_weights(a[2], a[0].dtype),
              fg.grouptail_plain, "group tail"),
    "mdta1": (fm, "mdta_stage1",
              lambda m, a: m.pack_stage1_weights(a[3], a[4], a[0].dtype),
              fm.mdta_stage1_plain, "MDTA stage 1"),
    "mdta2": (fm, "mdta_stage2",
              lambda m, a: m.pack_stage2_weights(a[4], a[7], a[0].dtype),
              fm.mdta_stage2_plain, "MDTA stage 2"),
    "msa1": (fal, "msa_stage1", None, fal.msa_stage1_plain,
             "dual-MSA stage 1"),
    "msa2": (fal, "msa_stage2",
             lambda m, a: m.pack_stage2_weights(a[5], a[6], a[0].dtype),
             fal.msa_stage2_plain, "dual-MSA stage 2"),
    "eg1": (fe, "eg1_rows", None, fe.eg1_rows_plain, "EGLA eg1"),
    "eg2": (fe, "eg2_local_fuse", None, fe.eg2_local_fuse_plain, "EGLA eg2"),
    "body": (fbody, "block_body",
             lambda m, a: m.pack_body_weights(a[1], a[3], a[0].dtype),
             fbody.block_body_plain, "Block_ body pair"),
    "warp": (wb, "flow_warp_ring_block", None, wb.flow_warp_ring_block_plain,
             "block warp"),
    "dots": (pd, "dot_case", None, pd.dot_case_plain, "dot probe"),
    "rowpipe": (pd, "rowpipe", None, pd.rowpipe_plain, "rowpipe probe"),
    "kstack": (pd, "kstack", None, pd.kstack_plain, "kstack probe"),
    "gather": (pm, "gather", None, pm.gather_plain, "DMA probe's gather"),
}
# the ring slots the block warp reads
WARP_SLOTS = 8
# the probes' cases (chip_smoke.py's timed ones): the dot probe's (m, k, n,
# reps), the row probes' (m, c, n, reps, nrows) by how their weights split,
# the gather's (h, w, c, patches) with the ring copies its chains walk
PROBE_DOT = (256, 192, 516, 2048)
PROBE_ROWS = {"out": (256, 64, 516, 1024, 8), "in": (64, 256, 516, 1024, 8)}
PROBE_DMA = (272, 480, 64, 68 * 120)
COLD_COPIES = 16


def probe_args(kind, g, split="out"):
    """The probe's arguments at its timed case, and its label."""
    if kind == "dots":
        m, k, n, reps = PROBE_DOT
        return (*kc.dots_args(g, m, k, n), reps), f"{PROBE_DOT}"
    if kind in ("rowpipe", "kstack"):
        m, c, n, reps, nrows = PROBE_ROWS[split]
        return (*kc.rows_args(g, m, c, n, nrows), reps, nrows), \
            f"{PROBE_ROWS[split]}"
    h, w, c, nblk = PROBE_DMA
    ring, starts = kc.dma_args(np.random.RandomState(0), h, w, c, nblk, 6)
    ph, pw = pm.PATCHES["patch"]
    return (ring, starts, ph, pw * c), f"{nblk} patches of ({ph}, {pw * c})"


def gather_chain(fn, args):
    """One gather call's ms in a CUDA graph of ``COLD_COPIES`` calls, each
    on its own copy of the ring (out of L2 when it is read)."""
    ring, *rest = args
    copies = [ring] + [ring.clone() for _ in range(COLD_COPIES - 1)]
    replay = captured(lambda: [fn(r, *rest) for r in copies])

    def run():   # (the graph reads the copies: they stay alive with it)
        replay()
        return copies

    return run, 1.0 / COLD_COPIES


def other_module(root: Path, module: str):
    """``ops.<module>`` of the checkout at ``root``, imported as a package
    of its own so that it builds and loads its own kernel."""
    name = "cdfo_tpu_torch_other"
    if name not in sys.modules:
        init = root / "cdfo_tpu_torch" / "__init__.py"
        spec = importlib.util.spec_from_file_location(
            name, init, submodule_search_locations=[str(init.parent)])
        package = importlib.util.module_from_spec(spec)
        sys.modules[name] = package
        spec.loader.exec_module(package)
    return importlib.import_module(f"{name}.ops.{module}")


def ways(kind, module, args):
    """{way: fn()} of ``WAYS`` for one side (the first only where its
    wrapper takes no pack)."""
    _, wrapper, pack_of, _, _ = KERNELS[kind]
    fn = getattr(module, wrapper)
    found = {WAYS[0]: lambda: fn(*args)}
    if "packed" not in inspect.signature(fn).parameters:
        return found
    packed = pack_of(module, args)
    found[WAYS[1]] = lambda: fn(*args, packed=packed)
    found[WAYS[2]] = lambda: pack_of(module, args)
    return found


@torch.no_grad()
def main(argv=None):
    require_card("compare_block")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", type=Path, required=True,
                   help="root of the other checkout")
    p.add_argument("--kernel", choices=list(KERNELS), default="block")
    p.add_argument("--split", choices=list(PROBE_ROWS), default="out",
                   help="the row probes' case: weights split by output or "
                   "input channels")
    p.add_argument("--b", type=int, default=4)
    p.add_argument("--h", type=int, default=272)
    p.add_argument("--w", type=int, default=480)
    p.add_argument("--reps", type=int, default=15)
    a = p.parse_args(argv)
    kind = a.kernel
    module, _, _, plain, what = KERNELS[kind]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(1)
    if kind in ("mdta1", "mdta2", "msa1", "msa2"):
        args = kc.align_embed_args(kind, torch.bfloat16, g, (a.b, a.h, a.w),
                                   6)
    elif kind in ("eg1", "eg2"):
        args = kc.egla_args(kind, torch.bfloat16, g, (a.b, a.h, a.w, 64))
    elif kind == "body":
        args = kc.body_args(torch.bfloat16, g, (a.b, a.h, a.w, 64))
    elif kind == "warp":
        args = kc.warp_args("blocky", torch.bfloat16, g,
                            (WARP_SLOTS, 6 * a.b, a.h, a.w))
    elif kind in ("dots", "rowpipe", "kstack", "gather"):
        args, label = probe_args(kind, g, a.split)
    else:
        args = kc.trunk_args(kind, torch.bfloat16, g, (a.b, a.h, a.w, 64),
                             nbr=6)
    modules = {"other": other_module(a.other.resolve(),
                                     module.__name__.split(".")[-1]),
               "this": module}
    sides = {side: ways(kind, mod, args) for side, mod in modules.items()}
    ref = plain(*args)
    tol = kc.tolerance(torch.bfloat16, kind)
    for side, fns in sides.items():
        for way in WAYS[:2]:
            if way not in fns:
                continue
            err, scale = kc.worst_error(fns[way](), ref, kind)
            print(f"{side}, {way}: against plain rel {err / scale:.3e} "
                  f"(tolerance {tol:.1e})", flush=True)
            if not err <= tol * scale:
                raise AssertionError(f"{side} disagrees with plain")
    scale = {}
    if kind == "gather":   # chains in CUDA graphs: the call is shorter
        for side, fns in sides.items():   # than its host work
            fns[WAYS[0]], scale[side] = gather_chain(
                getattr(modules[side], KERNELS[kind][1]), args)
    ms = {(side, way): [] for side in sides for way in sides[side]}
    for side in ("other", "this", "this", "other"):
        for way, fn in sides[side].items():
            ms[side, way].append(scale.get(side, 1.0) * float(
                np.median(event_ms(fn, a.reps, warmup=3))))
    if kind not in ("dots", "rowpipe", "kstack", "gather"):
        label = f"{tuple(args[2 if kind == 'warp' else 0].shape)}"
    print(f"{what} {label} bf16, ms a call in turns (other, this, this, "
          f"other) [{card}]:")
    for way in WAYS:
        o, t = ms.get(("other", way)), ms.get(("this", way))
        if t is None:
            continue
        if o is None:
            print(f"  {way:20s} other -, this {t[0]:.4f} {t[1]:.4f}",
                  flush=True)
            continue
        print(f"  {way:20s} other {o[0]:.4f} {o[1]:.4f}, this {t[0]:.4f} "
              f"{t[1]:.4f}: this / other {np.mean(t) / np.mean(o):.4f}",
              flush=True)


if __name__ == "__main__":
    main()
