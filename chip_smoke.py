#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cdfo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU mode: without a
CUDA device the script exits non-zero before printing any result):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build of every hand-written CUDA kernel from ``cdfo_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once, with each library's ``ptxas``
   register, spill and C75xx (``wgmma``) lines; a library whose ``wgmma``
   products ``ptxas`` serializes fails the run, and so does a spill or a
   C75xx line in the probes' libraries (``probe_dots``, ``probe_dma``);
3. each kernel against its plain PyTorch version on the card, in float32
   and bfloat16, with kernel and plain times (CUDA events, median of 15) at
   the main path's shapes: the attention kernel at its row and column
   shapes and at ragged ones, one past the 512 positions the bf16 kernel
   keeps resident (and ``scaled_dot_product_attention``, the one PyTorch
   call that computes the same function, as its library time); the
   four fused-trunk kernels (``Block_``, group tail, head, alignment tail)
   at the 272x480, k=4 shapes and at a ragged even shape (an odd extent
   must be refused); the two MDTA passes at (4, 272, 480, 64) and (2, 18,
   34, 64), the two dual-MSA passes at 24 neighbours of 4 centres of
   272x480 and at 3 neighbours of 2 centres of 18x34; EGLA's eg1 and eg2
   at (4, 272, 480, 64) and at (2, 20, 40, 64) and (2, 24, 40, 64) (eg2
   must refuse H = 20); the int8 ``Block_`` at the trunk's two shapes (an
   odd extent must be refused), its values past the lagged scale counted
   alike by kernel and plain version, timed in turns with the exact ``Block_`` (exact,
   int8, int8, exact), both with their weights packed once; the alignment
   tail, the head, the group tail, both MDTA passes and dual-MSA stage 2
   also with their packs kept (the group tail beside cuDNN's ``F.conv2d``
   alone, its conv without the skip add);
   the block-gather ring warp at 24 neighbour images of
   a ring of 8 272x480 frames and at (5 of 3, 20, 36), on flows constant
   over 4x4 blocks, on those with a mixed bottom band and single moved
   pixels, and on arbitrary flows: bit for bit equal to its plain version,
   the same path in every block, within tolerance of the per-pixel
   ``flow_warp_ring``, with ``F.grid_sample`` as its library time; the
   ``Block_`` body pair at the trunk's two shapes, also with its pack kept,
   with cuDNN's two convolutions as its library time; the dot probes (``dot_case`` at its
   three widths, m = 64 with K split over CTAs, m = 128 and 256 with
   resident planes, with one ``torch.matmul`` over K = reps * k as its
   library time, and the timed case's planes also streamed, at the same
   K; ``rowpipe`` and ``kstack``, which must refuse reps <= nrows, and
   ``rowpipe`` also with its weights split by input channels over a
   cluster, m = 64, c = 256) and the
   DMA probes (the gather at its tool's 8160 patches, with ``ring[index]``
   as its library time; the big copy, with ``clone()``; these two timed as
   CUDA-graph replays, their work being shorter than their wrappers' host
   work, in chains over 16 copies of the ring, so that each call reads
   device memory, as the block warp's ring of 8 frames does; their warm,
   L2-resident times are printed beside, and the rate at which the
   gather's copies cross from L2 into the SMs, beside the warm big
   copy's).
   Each output is held against the plain one slice by slice, each slice
   against its own largest value (``kernel_cases``: the MDTA and dual-MSA
   statistics per image and gram, their feature maps and EGLA's outputs
   per image). Each kernel's bound is computed from its inputs: the larger
   of its bytes (inputs read once, outputs written once; for the DMA
   probes the distinct bytes of the ring their patches or rows cover) over
   3.35 TB/s and its operations over the peak of their type (989 TFLOP/s
   bf16 tensor cores, 1979 TOP/s int8, 67 TFLOP/s fp32);
4. six small CVSR_V8 (2 trunk groups, 16x24 frames) through the streaming
   engine on the card (float32, kernels on, TF32 off) against the same
   weights through the same engine on the CPU (plain versions): uint8
   frames within 1 LSB, with no fused flag, with ``fused_trunk``, with
   ``fused_trunk``, ``fused_embed`` and ``fused_align``, with those and
   ``fused_egla``, and with all four and ``trunk_int8`` (path A; the CPU
   walks the kernel's step geometry) or ``block_warp`` (path B);
5. the full-width slice: CVSR_V8 at its default widths (nf=64, 7 trunk
   groups), bfloat16, seeded random weights, ``BatchedStreamingEngine(k=4)``
   on a 12-frame 272x480 synthetic sequence in timed mode, unfused, with
   ``fused_trunk``, with ``fused_trunk``, ``fused_embed`` and
   ``fused_align``, with all four flags (the main path of the exact
   trunk), and with all four and ``trunk_int8`` (path A: the JAX headline
   configuration), ``block_warp`` (path B) or both (the same weights each
   time); checks the (12, 1080, 1920) uint8 output, that every
   ``compensate_frames`` call launched the attention kernel twice (row and
   column stage) or, with ``fused_egla``, the column stage, eg1 and eg2
   once each, and, with ``fused_embed``, 3 of each MDTA pass, that every
   ``align_reconstruct`` call of a fused run launched 21 ``Block_``, 7
   group-tail, 1 head and 1 tail kernels and, with ``fused_align``, 1 of
   each dual-MSA pass, with ``trunk_int8`` 21 int8 ``Block_`` and no exact
   one, with ``block_warp`` 1 warp kernel, and that the fused frames are
   within 40 dB PSNR of the unfused ones (30 dB with ``trunk_int8``, whose
   PSNR against the exact four-flag frames says what int8 costs under
   these weights; the share of y1 / y2 values past the lagged scale of one
   trunk call is printed beside it); then times each stage of one engine step alone
   (``compensate_frames``, ``embed``, EGLA, ``align_reconstruct``, its
   neighbour warp and ``DualAttAlignment``, tsa, trunk, head); path AB
   also runs the served (untimed) mode, whose fps by wall time it prints
   beside the timed fps, its frames equal to the timed mode's bit for bit;
6. the trunk microbenchmarks, ``cdfo_tpu_torch.tools.microbench_trunk``
   (bf16 defaults), ``microbench_dots`` in its three modes and
   ``microbench_dma`` (patch, row, big) at their TPU tools' case lists,
   each case held against its plain version before it is timed; every
   kernel of the tools must launch;
7. training: (a) the four kernels training runs (the row and column
   attention, the ``Block_``, the group tail, the head) against their
   plain versions at the LD preset's shapes (rows (7680, 64, 64), columns
   (120, 64, 64, 64), the trunk and head (20, 64, 64, 64)), float32 and
   bfloat16, with phase 3's slices and tolerances; (b) two train steps of
   a float32 CVSR_V8 (nf 64, 2 trunk groups, the sampled mask, batch 2 of
   7 16x24 frames, TF32 off) on the card against the same weights,
   batches and gumbel draw on the CPU, unfused and with ``fused_trunk``:
   loss within 1e-4 relative, each gradient and each parameter after the
   second Adam step within 1e-3 relative L2, and the kernels' launches;
   (c) the LD preset through ``train_loop`` (nf 64, 7 trunk groups, 7
   frames, batch 20, 64x64 crops, the sampled mask, ``fused_trunk``, bf16
   with float32 master weights) on a synthetic CVCP tree the port's io
   writes to a temporary directory (2 sequences of 10 64x96 frames), 2
   warm-up and 5 timed steps: every loss finite, each step's forward
   launching the row and the column attention once each, 21 ``Block_``,
   7 group tails and 1 head and its backward none; s/step, samples/s and
   peak memory; one step's forward, backward and update times; then a new
   loop resumes from the checkpoint written at the
   end with equal parameters, masters, optimizer state and step, and takes
   its next step; then the same run unfused (with its breakdown), whose first-step loss (same
   weights, batch and gumbel noise) must be within 1e-2 relative of the
   fused one.
8. evaluation: (a) every model-path kernel (#1-#12) against its plain
   version in bfloat16, phase 3's slices and tolerances, at the JCT-VC
   geometries 400x640 and 184x320, at the engine's k = 4 shapes and at the
   per-window ones (1 frame; 6 neighbours of 1 centre; EGLA over 6
   frames), untimed; (b) ``StreamingInferencer`` on 8 synthetic 272x480
   frames (full width, bf16, the seeded weights) unfused, with the four
   flags and with path A: forward-only fps by the JAX protocol, each
   window's launches (the forward keeps the plain dual MSA and alignment
   tail, as cdfo_tpu's ``__call__`` does), the fused frames >= 40 dB from
   the unfused ones (30 with ``trunk_int8``) and each run >= 40 dB from
   the engine's frames for the same flags; (c) ``tools/eval_jctvc``'s
   ``evaluate_jctvc`` on a synthetic eval tree (3 frames each of 400x640
   and 184x320) with the seeded weights as a reference-style ``.pth``,
   unfused and path A: its JSON lines, path A >= 30 dB from unfused;
   (d) the engine with the sampled mask (``fused_trunk``, bf16, 8 frames
   of 272x480): two seeds give other frames, one seed the same frames
   timed and untimed; (e) ``tools/int8_delta`` at its defaults (a CVSR_V8
   of nf 64 and 2 groups trained 300 steps on 32x32 structured video):
   the plain, exact and int8 trunks' PSNRs on the same weights and the
   int8 trunk's values past the lagged scale, |int8 - plain| <= 0.05 dB
   (``BASELINE.md``), and beside them, on the same weights, the TPU's int8
   scheme (its kernel's steps, clipping; the plain version, on the CPU) and
   the bfloat16 trunks' PSNRs;
   (f) ``tools/gumbel_variance`` at 4 seeds: the sampled PSNRs differ;
9. the model zoo: (a) card against CPU (float32, TF32 off, phase 4's size,
   the same weights): each CVSR_V8 ablation (woPAB, woLA, woGA, woMV, woPd,
   no EGLA) through the engine unfused and with every kernel flag it
   admits (woPd also with ``trunk_int8``), CVSR_V9 (``fused_trunk``) and
   CVSR_V7 through the inferencer, uint8 within 1 LSB; SIDECVSR's forward
   with and without ``pre_l1`` within 1e-4; (b) each ablation at full
   width (nf 64, 7 groups, bf16, ``BatchedStreamingEngine(k=4)``, 12
   frames of 272x480) unfused and with its flags and ``trunk_int8``: fps,
   peak memory, each kernel's launches against the table of the modules
   it keeps, the fused frames >= 30 dB from the unfused; (c) CVSR_V9
   (``fused_trunk`` + ``fused_embed``, then with ``trunk_int8``) and
   CVSR_V7 through ``StreamingInferencer`` on 8 frames of 272x480, bf16:
   fps by the JAX protocol, peak memory, launches per window; SIDECVSR
   over 8 windows: ms per window, peak memory; (d) two LD-preset train
   steps unrolled against ``scan_trunk`` (same weights, batch and gumbel
   draw, deterministic algorithms): losses within 1e-4, parameters within
   1e-3 relative L2, both peaks. Zoo models get the seeded weights with
   every all-zero weight (CVSR_V7's offset heads, the norms' biases)
   refilled with seeded values.
10. the multi-card paths, over a process group that the phase makes and
   destroys: (a) path AB at full width (bf16, 12 frames of 272x480, k = 4)
   through ``ShardedServingEngine`` over one card (NCCL) and through the
   plain engine, timed in turns (plain, sharded, sharded, plain), each
   run's launches against path AB's table: frames equal bit for bit, both
   fps, both peaks and the ``all_gather``'s bytes and ms a step; (b) two
   LD-preset steps through ``train_loop`` (fused trunk, bf16, deterministic
   algorithms) without a process group and data-parallel over the one-card
   group: losses, parameters and masters equal; (c) with two or more
   cards, the sharded engine over 2 .. all cards (a spawned process each)
   on 12 frames a card against the plain engine on one: frames within
   rounding (>= 50 dB; the bootstrap's batch is k + 6 frames), fps by card
   count; on one card a line says that (c) did not run.

Every model gets the same seeded weights with its EGLA residual mask made
one-hot (``kernel_cases.excite_egla_mask``; under random weights it is all
zero, which would zero the fused EGLA's q projection), and each slice
prints the mask's set bits per frame of one ``compensate_frames`` call.

After phase 6 one line orders every kernel on a model path by launches x
(time - bound) per 12-frame run, its launches from the run of its own path:
the order in which a redesign gains most. Phases 7-10 follow it.

The line before the last is a JSON object with one entry per kernel
wrapper (launches from the four-flag run; the int8 ``Block_``'s from path
A's, the warp's from path B's, and those of the body pair and the probes,
which no model path runs, from phase 6's run of the tools; the five
trained wrappers also with ``train_launches_per_step``, their launches in
one LD training step's forward, and the kernels the inferencer runs with
``window_launches_per_frame``, from phase 8(b)); the last line is ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --train
    python3 chip_smoke.py --eval
    python3 chip_smoke.py --zoo
    python3 chip_smoke.py --parallel

build the kernels and run phase 7, phase 8, phase 9 or phase 10 alone.

    python3 chip_smoke.py --profile

builds the kernels and instead profiles one timed 12-frame run of the main
path (``torch.profiler``): device time by kernel, in order, and the
device's busy share of the run's wall time. Flags named after it are added
to the four (``--profile trunk_int8 block_warp``).

    python3 chip_smoke.py --phases [msa1 msa2 eg1 eg2 blockq block tail
                                    head mdta1 group mdta2 warp body]

builds both dual-MSA passes, eg1 (twice: its projection and band walk's
marks, then its row attention's), eg2, the int8 ``Block_``, the exact one,
the alignment tail, the head, the group tail, both MDTA passes, the block
warp and the body pair (or those named) with their phase clocks compiled
in and prints, at the main shapes in bfloat16, the cycles spent in each
phase: per step for the walks (dual-MSA stage 1's (centre, 128 pixels)
steps of one neighbour, stage 2's (centre, 128 pixels, neighbour) steps,
eg1's two rows a step and its row attention's 64-query tiles, eg2's three
windows a step, the int8 kernel's walk down its strips, the tail's, the
head's, MDTA stage 1's and the body pair's cluster walk row by row, the
group tail's and MDTA stage 2's two rows a step, the block warp's block
by block), as the kernels count their steps, and per CTA for the exact
``Block_``. The int8
``Block_``'s other launch, its 0.5x branch, has no marks: ``--profile``
gives its device time.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from cdfo_tpu_torch import ModelConfig
from cdfo_tpu_torch.config import DataConfig, TrainConfig
from cdfo_tpu_torch.data import io as data_io
from cdfo_tpu_torch.infer import (BatchedStreamingEngine, StreamingInferencer,
                                  synthetic_sequence)
from cdfo_tpu_torch.models import CVSRV8
from cdfo_tpu_torch.models.layers import lrelu
from cdfo_tpu_torch.ops import cuda_build
from cdfo_tpu_torch.ops import fused_align as fal
from cdfo_tpu_torch.ops import fused_attention as fa
from cdfo_tpu_torch.ops import fused_block as fbody
from cdfo_tpu_torch.ops import fused_block2 as fb
from cdfo_tpu_torch.ops import fused_block2_q as fq
from cdfo_tpu_torch.ops import fused_egla as fe
from cdfo_tpu_torch.ops import fused_groupconv as fg
from cdfo_tpu_torch.ops import fused_head as fh
from cdfo_tpu_torch.ops import fused_mdta as fm
from cdfo_tpu_torch.ops import fused_tail as ft
from cdfo_tpu_torch.ops import kernel_cases as kc
from cdfo_tpu_torch.ops import probe_dma as pm
from cdfo_tpu_torch.ops import probe_dots as pd
from cdfo_tpu_torch.ops import warp_block as wb
from cdfo_tpu_torch.ops.warp import flow_warp_ring
from cdfo_tpu_torch.parallel import initialize_distributed
from cdfo_tpu_torch.parallel.serving import ShardedServingEngine
from cdfo_tpu_torch.tools import captured, event_ms, microbench_dma
from cdfo_tpu_torch.tools import eval_jctvc, gumbel_variance, int8_delta
from cdfo_tpu_torch.tools import microbench_dots, microbench_trunk
from cdfo_tpu_torch.train.loop import train_loop
from cdfo_tpu_torch.losses import charbonnier_loss
from cdfo_tpu_torch.train.state import TrainState, model_inputs, train_step

SOURCE = "cdfo_tpu_torch/csrc/fused_attention.cu"
REPLACES = "cdfo_tpu/ops/fused_attention.py:43"
LIBRARIES = ("fused_attention", "fused_block2", "fused_groupconv",
             "fused_head", "fused_tail", "fused_mdta", "fused_align",
             "fused_egla", "fused_block2_q", "warp_block", "fused_block",
             "probe_dots", "probe_dma")
# the libraries whose ptxas lines must show no spill and no C75xx
PROBE_LIBRARIES = ("probe_dots", "probe_dma")
# the fused-trunk kernels: JSON name, wrapper, plain version, source, the
# TPU kernel it replaces
TRUNK_KERNELS = {
    "block": ("fused_block2.scale_block", fb.scale_block,
              fb.scale_block_plain, "cdfo_tpu_torch/csrc/fused_block2.cu",
              "cdfo_tpu/ops/fused_block2.py:375"),
    "group": ("fused_groupconv.grouptail", fg.grouptail, fg.grouptail_plain,
              "cdfo_tpu_torch/csrc/fused_groupconv.cu",
              "cdfo_tpu/ops/fused_groupconv.py:107"),
    "head": ("fused_head.fused_head", fh.fused_head, fh.fused_head_plain,
             "cdfo_tpu_torch/csrc/fused_head.cu",
             "cdfo_tpu/ops/fused_head.py:207"),
    "tail": ("fused_tail.resblock_pair", ft.resblock_pair,
             ft.resblock_pair_plain, "cdfo_tpu_torch/csrc/fused_tail.cu",
             "cdfo_tpu/ops/fused_tail.py:193"),
}
# per align_reconstruct call at 7 trunk groups
TRUNK_LAUNCHES = {"block": 21, "group": 7, "head": 1, "tail": 1}
# NHWC shapes: the main path's at 272x480, k=4 (the tail's batch is 6k
# neighbour images, 3 neighbours per image in the ragged case), then ragged
# ones (not multiples of any tile)
TRUNK_MAIN = (4, 272, 480, 64)
TRUNK_SHAPES = (TRUNK_MAIN, (2, 18, 34, 64))
# (wrapper, shape): the main path's row and column shapes at 272x480, k=4,
# then ragged ones (N not a multiple of the 64-row tile)
KERNEL_CASES = [
    ("token", (1088, 480, 64)),
    ("column", (4, 272, 480, 64)),
    ("token", (3, 270, 64)),
    ("token", (2, 33, 64)),
    ("column", (2, 33, 20, 64)),
    ("column", (2, 273, 5, 64)),
    ("token", (3, 520, 64)),   # bf16: past the 512 positions kept resident
]
WRAPPERS = {
    "token": (fa.token_self_attention, fa.token_attention_plain),
    "column": (fa.column_self_attention, fa.column_attention_plain),
}
# the fused embed and alignment kernels: JSON name, wrapper, plain version,
# source, the TPU kernel it replaces
ALIGN_EMBED_KERNELS = {
    "mdta1": ("fused_mdta.mdta_stage1", fm.mdta_stage1, fm.mdta_stage1_plain,
              "cdfo_tpu_torch/csrc/fused_mdta.cu",
              "cdfo_tpu/ops/fused_mdta.py:157"),
    "mdta2": ("fused_mdta.mdta_stage2", fm.mdta_stage2, fm.mdta_stage2_plain,
              "cdfo_tpu_torch/csrc/fused_mdta.cu",
              "cdfo_tpu/ops/fused_mdta.py:344"),
    "msa1": ("fused_align.msa_stage1", fal.msa_stage1, fal.msa_stage1_plain,
             "cdfo_tpu_torch/csrc/fused_align.cu",
             "cdfo_tpu/ops/fused_align.py:107"),
    "msa2": ("fused_align.msa_stage2", fal.msa_stage2, fal.msa_stage2_plain,
             "cdfo_tpu_torch/csrc/fused_align.cu",
             "cdfo_tpu/ops/fused_align.py:191"),
}
# per compensate_frames call (fused_embed) and per align_reconstruct call
# (fused_align)
EMBED_LAUNCHES = {"mdta1": 3, "mdta2": 3}
ALIGN_LAUNCHES = {"msa1": 1, "msa2": 1}
# (images or centres, H, W), neighbours per centre: the main path's at
# 272x480, k=4, then ragged ones
ALIGN_EMBED_SHAPES = (((4, 272, 480), 6), ((2, 18, 34), 3))
# the fused EGLA kernels, launched once each per compensate_frames call
# (fused_egla); their NHWC shapes: the main path's, then ragged ones (eg1:
# H not a multiple of the TPU's 16 rows, W of the 64-key tile)
EGLA_KERNELS = {
    "eg1": ("fused_egla.eg1_rows", fe.eg1_rows, fe.eg1_rows_plain,
            "cdfo_tpu_torch/csrc/fused_egla.cu",
            "cdfo_tpu/ops/fused_egla.py:98"),
    "eg2": ("fused_egla.eg2_local_fuse", fe.eg2_local_fuse,
            fe.eg2_local_fuse_plain, "cdfo_tpu_torch/csrc/fused_egla.cu",
            "cdfo_tpu/ops/fused_egla.py:185"),
}
EGLA_LAUNCHES = {"eg1": 1, "eg2": 1}
EGLA_MAIN = (4, 272, 480, 64)
EGLA_RAGGED = {"eg1": (2, 20, 40, 64), "eg2": (2, 24, 40, 64)}
ALL_FLAGS = dict(fused_trunk=True, fused_embed=True, fused_align=True,
                 fused_egla=True)
# the int8 Block_ (21 launches per align_reconstruct call under trunk_int8,
# in place of the exact one) and the block-gather ring warp (1 under
# block_warp)
INT8_KERNELS = {
    "blockq": ("fused_block2_q.scale_block_q", fq.scale_block_q,
               fq.scale_block_q_plain, "cdfo_tpu_torch/csrc/fused_block2_q.cu",
               "cdfo_tpu/ops/fused_block2_q.py:373"),
}
WARP_KERNELS = {
    "warp": ("warp_block.flow_warp_ring_block", wb.flow_warp_ring_block,
             wb.flow_warp_ring_block_plain, "cdfo_tpu_torch/csrc/warp_block.cu",
             "cdfo_tpu/ops/warp_block.py:191"),
}
ALL_KERNELS = {**TRUNK_KERNELS, **ALIGN_EMBED_KERNELS, **EGLA_KERNELS,
               **INT8_KERNELS, **WARP_KERNELS}
# the kernels of the trunk microbenchmarks (no model path launches them;
# their launches are counted over phase 6's run of the three tools): the
# Block_ body pair, the dot probes and the DMA probes
BODY_KERNELS = {
    "body": ("fused_block.block_body", fbody.block_body,
             fbody.block_body_plain, "cdfo_tpu_torch/csrc/fused_block.cu",
             "cdfo_tpu/ops/fused_block.py:148"),
}
PROBE_KERNELS = {
    "dots": ("probe_dots.dot_case", pd.dot_case, pd.dot_case_plain,
             "cdfo_tpu_torch/csrc/probe_dots.cu",
             "tools/microbench_dots.py:53"),
    "rowpipe": ("probe_dots.rowpipe", pd.rowpipe, pd.rowpipe_plain,
                "cdfo_tpu_torch/csrc/probe_dots.cu",
                "tools/microbench_dots.py:123"),
    "kstack": ("probe_dots.kstack", pd.kstack, pd.kstack_plain,
               "cdfo_tpu_torch/csrc/probe_dots.cu",
               "tools/microbench_dots.py:189"),
    "gather": ("probe_dma.gather", pm.gather, pm.gather_plain,
               "cdfo_tpu_torch/csrc/probe_dma.cu",
               "tools/microbench_dma.py:89"),
    "big": ("probe_dma.big", pm.big, pm.big_plain,
            "cdfo_tpu_torch/csrc/probe_dma.cu", "tools/microbench_dma.py:89"),
}
TOOL_KERNELS = {**BODY_KERNELS, **PROBE_KERNELS}
# the probes' timed cases: the trunk's conv1-style product (M, K, N) or row
# (M, C, N) at a fixed rep count; the DMA probe at its tool's defaults
PROBE_DOT = (256, 192, 516, 2048)
PROBE_ROWS = (256, 64, 516, 1024)
PROBE_NROWS = 8
PROBE_DMA = (272, 480, 64, 68 * 120)
# copies of the DMA probes' ring that their timed chains walk in turn: 280
# MB, so that each call finds its copy evicted from the 50 MB L2
COLD_COPIES = 16
# (ring slots, neighbour images, H, W): k=4 centres of 6 neighbours from the
# engine's ring of 8, then a ragged one
WARP_MAIN = (8, 24, 272, 480)
WARP_SHAPES = (WARP_MAIN, (3, 5, 20, 36))
PATH_A = dict(ALL_FLAGS, trunk_int8=True)
PATH_B = dict(ALL_FLAGS, block_warp=True)
PATH_AB = dict(ALL_FLAGS, trunk_int8=True, block_warp=True)

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense bf16 tensor-core
# and fp32 CUDA-core FLOP/s, dense int8 tensor-core OP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8 = 1979e12


def flops(kind, args) -> float:
    """The multiply-adds (x2) the function needs on these inputs; the
    Block_ counts the down2-folded conv2 (a stride-2 4x4 conv from the 2x
    mid-channels), the least work for the same result."""
    x = args[0]
    c = x.shape[-1]
    if kind == "token":
        t, n, _ = x.shape
        return 4.0 * t * n * n * c
    if kind == "column":
        b, h, w, _ = x.shape
        return 4.0 * b * w * h * h * c
    if kind == "warp":   # 4 taps or their two-stage equivalent per value
        return 16.0 * args[2][..., 0].numel() * c
    p = float(x[..., 0].numel())   # pixels of the first operand
    if kind == "eg1":   # two projections, the row attention, the H-band
        return p * (4 * c * c + 4 * x.shape[2] * c + 18 * c)
    per_pixel = {
        # body at 1x and 0.25x (2 * 2*9*4C^2 each), up path at 4x conv1
        # (2*9*4C^2) + folded conv2 (2*16*4C^2) at 1x, the two 1x1s
        "block": 144 * c * c * 1.25 + 288 * c * c + 128 * c * c + 4 * c * c,
        # the int8 Block_'s part in the working type: the 0.5x body, the 1x1s
        "blockq": 144 * c * c * 0.25 + 4 * c * c,
        "group": 18 * c * c,
        "head": 40 * c * c + 288 * c,
        "tail": 72 * c * c,
        "mdta1": 12 * c * c + 54 * c,
        "mdta2": 22 * c * c,
        "msa1": 10 * c * c,
        "msa2": 10 * c * c,
        # the q and v projections, 64-token attention, the 128 -> 64 fuse
        "eg2": 4 * c * c + 4 * 64 * c + 4 * c * c,
        # conv3x3 64 -> 256 and 256 -> 64
        "body": 144 * c * c,
    }[kind]
    return per_pixel * p


def bound(kind, args, outs, dtype) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if isinstance(t, torch.Tensor))
    t_bytes = nbytes / PEAK_BYTES
    if kind == "warp":   # blended in float32 on the CUDA cores in any dtype
        t_ops = flops(kind, args) / PEAK_FLOPS[torch.float32]
    else:
        t_ops = flops(kind, args) / PEAK_FLOPS[dtype]
    if kind == "blockq":   # conv1 at 1x and 2x, conv2 and the folded conv2
        t_ops += (flops("block", args) - flops(kind, args)) / PEAK_INT8
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps: int = 15) -> float:
    return float(np.median(event_ms(fn, reps, warmup=3)))




def reset_launches():
    fa.token_self_attention.launches = 0
    fa.column_self_attention.launches = 0
    for _, wrapper, *_ in (*ALL_KERNELS.values(), *TOOL_KERNELS.values()):
        wrapper.launches = 0


@torch.no_grad()
def check_kernel_table(card: str, table: dict, cases, seed: int,
                       plain_reps: int = 15,
                       dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """Phase 3 for the kernels of ``table`` ({kind: (JSON name, wrapper,
    plain version, source, replaces)}): each against its plain version in
    each of ``dtypes`` on every case ``(label, main, args_of)``, where
    ``args_of(kind, dtype, g)`` draws the inputs; at the main case also
    kernel, plain and bound times. Returns the JSON fields of each kernel,
    measured at the main case in bfloat16 (the full slice's dtype). TF32 is
    off, so the float32 plain side is full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    fields = {}
    for dtype in dtypes:
        for label, main, args_of in cases:
            for kind, (name, kernel, plain, _, _) in table.items():
                args = args_of(kind, dtype, g)
                out = kernel(*args)
                ref = plain(*args)
                torch.cuda.synchronize()
                err, scale = kc.worst_error(out, ref, kind)
                max_abs = kc.max_abs_error(out, ref)
                line = (f"kernel {name} {label} {str(dtype)[6:]}: max_abs_err "
                        f"{max_abs:.3e}; worst slice {err:.3e} (max |plain| "
                        f"{scale:.3f} there, rel {err / scale:.3e}, "
                        f"tolerance rel {kc.tolerance(dtype, kind):.1e})")
                if main:
                    ms = median_ms(lambda: kernel(*args))
                    plain_ms = median_ms(lambda: plain(*args), plain_reps)
                    bound_ms, bound_by = bound(kind, args, out, dtype)
                    line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                             f"bound {bound_ms:.3f} ms ({bound_by}) [{card}]")
                    if dtype == torch.bfloat16:
                        fields[kind] = {"max_abs_err": max_abs, "ms": ms,
                                        "plain_ms": plain_ms,
                                        "bound_ms": bound_ms,
                                        "bound_by": bound_by,
                                        "library_ms": None}
                print(line, flush=True)
                if not err <= kc.tolerance(dtype, kind) * scale:
                    raise AssertionError(f"kernel disagrees with plain: "
                                         f"{line}")
                del args, out, ref
            torch.cuda.empty_cache()
    return fields


@torch.no_grad()
def pack_kept_ms(card: str, fields: dict, kind: str, args, pack, label: str):
    """A wrapper's bfloat16 time at ``args`` with its weights packed once
    (``pack(args)``), as the model (or the trunk microbenchmark) keeps
    them: the JSON line's ``ms``, the time per call with the packing beside
    it."""
    name, wrapper = {**ALL_KERNELS, **TOOL_KERNELS}[kind][:2]
    packed = pack(args)
    kept = median_ms(lambda: wrapper(*args, packed=packed))
    print(f"kernel {name} {label} bfloat16: {kept:.3f} ms with the pack "
          f"kept, {fields[kind]['ms']:.3f} per call with the packing "
          f"[{card}]", flush=True)
    fields[kind]["ms"] = kept


@torch.no_grad()
def cudnn_conv_ms(x, w, b) -> str:
    """The median ms of one ``F.conv2d`` of NHWC ``x`` (a channels_last
    view) with ``w`` (channels_last) and bias ``b``, padding 1: cuDNN's
    conv alone, printed beside the group tail."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.contiguous(memory_format=torch.channels_last)
    return f"{median_ms(lambda: F.conv2d(xc, wc, b, padding=1)):.3f}"


def check_trunk_kernels(card: str) -> dict:
    """Phase 3, fused-trunk part: ``check_kernel_table`` at the trunk
    shapes (the table's times per call, with each wrapper's weight
    packing), the head, the alignment tail and the group tail also with
    their packs kept, as ``CVSRV8``, ``DualAttAlignment`` and ``SCNetFast``
    keep them (the JSON line's ``ms``; the group tail beside cuDNN's conv
    alone), then an odd extent the ``Block_`` must refuse."""
    fields = check_kernel_table(card, TRUNK_KERNELS, [
        (shape, shape == TRUNK_MAIN,
         lambda kind, dtype, g, shape=shape: kc.trunk_args(
             kind, dtype, g, shape, nbr=6 if shape == TRUNK_MAIN else 3))
        for shape in TRUNK_SHAPES], seed=1)
    g = torch.Generator(device="cuda").manual_seed(1)
    args = kc.trunk_args("tail", torch.bfloat16, g, TRUNK_MAIN, nbr=6)
    pack_kept_ms(card, fields, "tail", args, lambda a: ft.pack_tail_weights(
        a[3::2], a[4::2], torch.bfloat16), f"{TRUNK_MAIN} (24 neighbours)")
    args = kc.trunk_args("head", torch.bfloat16, g, TRUNK_MAIN)
    pack_kept_ms(card, fields, "head", args, lambda a: fh.pack_head_weights(
        *a[2:7], torch.bfloat16), f"{TRUNK_MAIN}")
    args = kc.trunk_args("group", torch.bfloat16, g, TRUNK_MAIN)
    pack_kept_ms(card, fields, "group", args,
                 lambda a: fg.pack_grouptail_weights(a[2], torch.bfloat16),
                 f"{TRUNK_MAIN}")
    print(f"cuDNN F.conv2d alone {TRUNK_MAIN} bfloat16 (channels_last, with "
          f"bias; the group tail's conv without its skip add: a floor for "
          f"any one-call version, not a library time): "
          f"{cudnn_conv_ms(*args[:1], *args[2:])} ms [{card}]", flush=True)
    del args
    odd = kc.trunk_args("block", torch.bfloat16, g, (1, 16, 23, 64))
    try:
        with torch.no_grad():
            fb.scale_block(*odd)
    except ValueError as e:
        print(f"odd extent refused: {e}", flush=True)
    else:
        raise AssertionError("fused_block2 took an odd extent")
    return fields


def check_align_embed_kernels(card: str) -> dict:
    """Phase 3, fused embed and alignment part: ``check_kernel_table`` at
    the MDTA images, or centres with their neighbours, of
    ``ALIGN_EMBED_SHAPES``, then both MDTA passes and dual-MSA stage 2
    with their packs kept, as ``PartitionTransformerSA2Fast`` and
    ``DualAttAlignment`` keep them (the JSON line's ``ms``)."""
    fields = check_kernel_table(card, ALIGN_EMBED_KERNELS, [
        (f"{shape} (MSA: {nbr} neighbours per centre)",
         (shape, nbr) == ALIGN_EMBED_SHAPES[0],
         lambda kind, dtype, g, shape=shape, nbr=nbr: kc.align_embed_args(
             kind, dtype, g, shape, nbr))
        for shape, nbr in ALIGN_EMBED_SHAPES], seed=2)
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = ALIGN_EMBED_SHAPES[0][0]
    args = kc.align_embed_args("mdta1", torch.bfloat16, g, shape, 6)
    pack_kept_ms(card, fields, "mdta1", args, lambda a: fm.pack_stage1_weights(
        a[3], a[4], torch.bfloat16), f"{shape}")
    args = kc.align_embed_args("mdta2", torch.bfloat16, g, shape, 6)
    pack_kept_ms(card, fields, "mdta2", args, lambda a: fm.pack_stage2_weights(
        a[4], a[7], torch.bfloat16), f"{shape}")
    args = kc.align_embed_args("msa2", torch.bfloat16, g, shape, 6)
    pack_kept_ms(card, fields, "msa2", args, lambda a: fal.pack_stage2_weights(
        a[5], a[6], torch.bfloat16), f"{shape} (6 neighbours per centre)")
    return fields


def check_egla_kernels(card: str) -> dict:
    """Phase 3, fused EGLA part: ``check_kernel_table`` at the main shape
    and the ragged ones, then an H off the 8x8 windows that eg2 must
    refuse."""
    fields = check_kernel_table(card, EGLA_KERNELS, [
        ("main", True, lambda kind, dtype, g: kc.egla_args(
            kind, dtype, g, EGLA_MAIN)),
        ("ragged", False, lambda kind, dtype, g: kc.egla_args(
            kind, dtype, g, EGLA_RAGGED[kind]))], seed=3)
    g = torch.Generator(device="cuda").manual_seed(3)
    bad = kc.egla_args("eg2", torch.bfloat16, g, (1, 20, 40, 64))
    try:
        with torch.no_grad():
            fe.eg2_local_fuse(*bad)
    except ValueError as e:
        print(f"eg2 at H = 20 refused: {e}", flush=True)
    else:
        raise AssertionError("fused_egla eg2 took H = 20")
    return fields


def check_int8_kernel(card: str) -> dict:
    """Phase 3, int8 ``Block_``: ``check_kernel_table`` at the trunk
    shapes (the plain version walks the kernel's step geometry), then the
    values past the lagged scale as kernel and plain version count them
    (the steps that hold them run again at their own amax), the outputs'
    correlation, and an odd extent that must be refused. The table's
    kernel time includes the wrapper's weight quantization and packing,
    which the trunk does once per model; the JSON line's ``ms`` is the
    time with the pack kept, as the trunk calls it, taken in turns with
    the exact ``Block_``'s under the same rule (which main() puts in the
    exact ``Block_``'s ``ms`` too; its time per call with the packing is
    in its phase-3 line)."""
    fields = check_kernel_table(card, INT8_KERNELS, [
        (shape, shape == TRUNK_MAIN,
         lambda kind, dtype, g, shape=shape: kc.trunk_args(kind, dtype, g,
                                                           shape))
        for shape in TRUNK_SHAPES], seed=4, plain_reps=3)
    g = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for shape in TRUNK_SHAPES:
            args = kc.trunk_args("blockq", torch.bfloat16, g, shape)
            out, clips = fq.scale_block_q(*args, clip_counts=True)
            ref, want = fq.scale_block_q_plain(*args, clip_counts=True)
            kc.assert_outputs_close(out, ref, torch.bfloat16, "blockq")
            exact = fb.scale_block(*args)
            err, scale = kc.worst_error(out, exact, "blockq")
            n = out.numel()
            print(f"int8 Block_ {shape} bf16: past the lagged scale y1 "
                  f"{clips[0]:.0f} of {4 * n} (plain {want[0]:.0f}), y2 "
                  f"{clips[1]:.0f} of {16 * n} (plain {want[1]:.0f}); "
                  f"against the exact kernel "
                  f"rel {err / scale:.3e} (cdfo_tpu's own bound: 5e-2)",
                  flush=True)
            if (clips - want).abs().max().item() > 2 + 0.01 * want.max().item():
                raise AssertionError("kernel and plain version count other "
                                     "values past the lagged scale")
            if not err <= 0.05 * scale:
                raise AssertionError("int8 Block_ is far from the exact one")
            if shape == TRUNK_MAIN:
                x, *params = args
                pq = fq.pack_weights_q(*params, x.dtype)
                pe = fb.pack_weights(*params, x.dtype)
                runs = {"exact": lambda: fb.scale_block(*args, packed=pe),
                        "int8": lambda: fq.scale_block_q(*args, packed=pq)}
                ms = {name: [] for name in runs}
                for name in ("exact", "int8", "int8", "exact"):
                    ms[name].append(median_ms(runs[name]))
                fields["blockq"]["ms"] = float(np.mean(ms["int8"]))
                fields["block_packed_ms"] = float(np.mean(ms["exact"]))
                print(f"int8 Block_ {shape} bf16, weights packed once: "
                      f"{ms['int8'][0]:.3f} and {ms['int8'][1]:.3f} ms; the "
                      f"exact Block_ before and after it {ms['exact'][0]:.3f} "
                      f"and {ms['exact'][1]:.3f} ms [{card}]", flush=True)
        odd = kc.trunk_args("blockq", torch.bfloat16, g, (1, 16, 23, 64))
        try:
            fq.scale_block_q(*odd)
        except ValueError as e:
            print(f"odd extent refused: {e}", flush=True)
        else:
            raise AssertionError("fused_block2_q took an odd extent")
    return fields


def grid_sample_warp(frames_nchw, grid):
    """The one PyTorch call computing the warp's function on frames
    already gathered from the ring (bilinear, zeros, align_corners=True at
    normalised grid + flow), timed as its library yardstick; the port
    never calls it."""
    return F.grid_sample(frames_nchw, grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)


@torch.no_grad()
def check_warp_kernel(card: str) -> dict:
    """Phase 3, block-gather ring warp: on every flow case and shape, in
    float32 and bfloat16, the kernel equals its plain version bit for bit
    and takes the same path per block (none in the bottom 4 rows), and
    both stay within tolerance of the per-pixel ``flow_warp_ring``; times
    at the main shape, JSON fields from the blocky case (the engine's
    flows) in bfloat16."""
    g = torch.Generator(device="cuda").manual_seed(5)
    fields = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in WARP_SHAPES:
            for case in kc.WARP_CASES:
                ring, idx, flow = args = kc.warp_args(case, dtype, g, shape)
                out, paths = wb.flow_warp_ring_block(*args, return_paths=True)
                ref, want = wb.flow_warp_ring_block_plain(*args,
                                                          return_paths=True)
                shipped = flow_warp_ring(*args)
                torch.cuda.synchronize()
                max_abs = kc.max_abs_error(out, ref)
                err, scale = kc.worst_error(out, shipped, "warp")
                line = (f"kernel warp_block {case} {shape} {str(dtype)[6:]}: "
                        f"max_abs_err {max_abs:.3e} against plain, patch path "
                        f"in {paths.float().mean().item():.4f} of the blocks; "
                        f"against flow_warp_ring worst slice {err:.3e} (rel "
                        f"{err / scale:.3e}, tolerance rel "
                        f"{kc.tolerance(dtype, 'warp'):.1e})")
                if shape == WARP_MAIN:
                    ms = median_ms(lambda: wb.flow_warp_ring_block(*args))
                    plain_ms = median_ms(
                        lambda: wb.flow_warp_ring_block_plain(*args), 5)
                    eager_ms = median_ms(lambda: flow_warp_ring(*args))
                    b, h, w, _ = flow.shape
                    frames = ring[idx].permute(0, 3, 1, 2)
                    f32 = flow.float()
                    gx = (torch.arange(w, device="cuda") + f32[..., 0]) \
                        * (2.0 / (w - 1)) - 1.0
                    gy = (torch.arange(h, device="cuda")[:, None]
                          + f32[..., 1]) * (2.0 / (h - 1)) - 1.0
                    grid = torch.stack([gx, gy], dim=-1).to(dtype)
                    lib = grid_sample_warp(frames, grid).permute(0, 2, 3, 1)
                    lib_err, _ = kc.worst_error(lib, shipped, "warp")
                    library_ms = median_ms(
                        lambda: grid_sample_warp(frames, grid))
                    bound_ms, bound_by = bound("warp", args, out, dtype)
                    line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                             f"flow_warp_ring {eager_ms:.3f} ms, "
                             f"F.grid_sample {library_ms:.3f} ms (worst slice "
                             f"{lib_err:.2e} from flow_warp_ring), bound "
                             f"{bound_ms:.3f} ms ({bound_by}) [{card}]")
                    if dtype == torch.bfloat16 and case == "blocky":
                        fields["warp"] = {
                            "max_abs_err": max_abs, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms}
                    del frames, grid, lib
                print(line, flush=True)
                if max_abs != 0.0 or not torch.equal(paths, want):
                    raise AssertionError(f"kernel disagrees with plain: "
                                         f"{line}")
                if paths[:, -1].any():
                    raise AssertionError("a bottom block took the patch path")
                if not err <= kc.tolerance(dtype, "warp") * scale:
                    raise AssertionError(f"block warp disagrees with "
                                         f"flow_warp_ring: {line}")
                del args, ring, idx, flow, out, ref, shipped
                torch.cuda.empty_cache()
    return fields


def check_body_kernel(card: str) -> dict:
    """Phase 3, the ``Block_`` body pair: ``check_kernel_table`` at the
    trunk's two shapes, the time with its pack kept (as the trunk
    microbenchmark keeps it; the JSON line's ``ms``), and cuDNN's two
    convolutions (the microbenchmark's ``plain_nhwc``) as its library time
    at the main one in bfloat16."""
    fields = check_kernel_table(card, BODY_KERNELS, [
        (shape, shape == TRUNK_MAIN,
         lambda kind, dtype, g, shape=shape: kc.body_args(dtype, g, shape))
        for shape in TRUNK_SHAPES], seed=6)
    g = torch.Generator(device="cuda").manual_seed(6)
    args = kc.body_args(torch.bfloat16, g, TRUNK_MAIN)
    pack_kept_ms(card, fields, "body", args, lambda a: fbody.pack_body_weights(
        a[1], a[3], torch.bfloat16), f"{TRUNK_MAIN}")
    with torch.no_grad():
        cudnn = microbench_trunk.candidates(*args)["plain_nhwc"]
        err, scale = kc.worst_error(cudnn().contiguous(),
                                    fbody.block_body_plain(*args), "body")
        fields["body"]["library_ms"] = median_ms(cudnn)
    print(f"kernel fused_block {TRUNK_MAIN} bfloat16: cuDNN's two convs "
          f"{fields['body']['library_ms']:.3f} ms (worst slice rel "
          f"{err / scale:.2e} from plain) against the kernel's "
          f"{fields['body']['ms']:.3f} [{card}]", flush=True)
    return fields


def chain_ms(fn, rings, wrapper=None) -> float:
    """The ms of one ``fn(ring)`` in a chain of calls over ``rings`` in
    turn: the difference of CUDA-graph chains of one and two rounds over
    them, per call (the DMA tool's method: it cancels the graph's launch
    and the host's per-call work). ``wrapper`` counts the replays."""
    def chain(rounds):
        for _ in range(rounds):
            for r in rings:
                fn(r)

    wrappers = () if wrapper is None else (wrapper,)
    t = {n: median_ms(captured(lambda n=n: chain(n), *wrappers), 5)
         for n in (1, 2)}
    return (t[2] - t[1]) / len(rings)


def _probe_timing(card, kind, kernel, plain, library, flop, nbytes,
                  ring=None, wrapper=None) -> dict:
    """Times ``kernel``, ``plain`` and ``library`` (None: no PyTorch call
    computes the function) and computes the bound; returns the JSON
    fields. With ``ring`` (the DMA probes') each is a function of the ring,
    and the kernel and library calls are timed in chains (``chain_ms``)
    over ``COLD_COPIES`` copies of it, so that each call finds its copy out
    of L2 and reads device memory at the bound's rate, as the block warp
    reads its ring of 8 frames; the warm times, one ring in L2, are
    printed beside, and the fields come back with the kernel's warm ms."""
    if ring is None:
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, 5)
        library_ms = None if library is None else median_ms(library, 5)
        warm = ""
    else:
        copies = [ring] + [ring.clone() for _ in range(COLD_COPIES - 1)]
        ms = chain_ms(kernel, copies, wrapper)
        library_ms = chain_ms(library, copies)
        plain_ms = median_ms(lambda: plain(ring), 5)
        one = [ring] * COLD_COPIES
        warm_ms = chain_ms(kernel, one, wrapper)
        warm = (f" (chained over {COLD_COPIES} copies of the ring, "
                f"{COLD_COPIES * ring.numel() * 2 / 1e6:.0f} MB; warm, one "
                f"ring in L2: kernel {warm_ms:.4f} ms, library "
                f"{chain_ms(library, one):.4f} ms)")
        del copies
    t_ops, t_bytes = flop / PEAK_FLOPS[torch.bfloat16], nbytes / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"probe {kind}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"library {lib}, bound {bound_ms:.4f} ms ({bound_by}){warm} "
          f"[{card}]", flush=True)
    if ms < bound_ms:
        raise AssertionError(f"probe {kind} ran faster than its bound")
    fields = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms}
    return fields if ring is None else (fields, warm_ms)


def covered_bytes(ring, yi, xi) -> int:
    """The distinct bytes of ``ring`` at the indices ``ring[yi, xi]``."""
    hit = torch.zeros(ring.shape, dtype=torch.bool, device=ring.device)
    hit[yi, xi] = True
    return int(hit.sum()) * ring.element_size()


def _probe_check(kind, out, ref) -> float:
    """Holds a probe's output against its plain version's; returns max
    |kernel - plain|."""
    torch.cuda.synchronize()
    err, scale = kc.worst_error(out, ref, kind)
    tol = kc.tolerance(torch.bfloat16, kind)
    max_abs = kc.max_abs_error(out, ref)
    print(f"probe {kind}: max_abs_err {max_abs:.3e} (max |plain| "
          f"{scale:.3f}, rel {err / max(scale, 1e-30):.3e}, tolerance rel "
          f"{tol:.1e})", flush=True)
    if not err <= tol * scale:
        raise AssertionError(f"probe {kind} disagrees with its plain version")
    return max_abs


@torch.no_grad()
def check_probe_kernels(card: str) -> dict:
    """Phase 3, the trunk probes: each held against its plain version on
    its timed case (the dot probe also at the two other widths of its
    tool's m and with resident planes; kstack at reps <= nrows must be
    refused), with kernel, plain, library and bound times. The dot probe's
    library call is one ``torch.matmul`` over K = reps * k of the same
    products; the gather's ``ring[index]`` of every patch; the big copy's
    ``clone()``."""
    g = torch.Generator(device="cuda").manual_seed(7)
    fields = {}
    m, k, n, reps = PROBE_DOT
    # the three widths: m = 64 with K split over CTAs, m = 128 and the
    # timed m = 256 with their planes resident
    for mm, kk, nn, rr in ((64, 768, 516, 9), (128, 128, 2064, 9),
                           (m, k, n, reps)):
        lhs, rhs = kc.dots_args(g, mm, kk, nn)
        err = _probe_check("dots", pd.dot_case(lhs, rhs, rr),
                           pd.dot_case_plain(lhs, rhs, rr))
    lhs_k = lhs.repeat(1, reps)
    rhs_k = rhs[torch.arange(reps, device="cuda") % rhs.shape[0]].reshape(
        reps * k, n)
    lib = torch.matmul(lhs_k, rhs_k)
    _probe_check("dots", lib, pd.dot_case_plain(lhs, rhs, reps))
    fields["dots"] = {"max_abs_err": err, **_probe_timing(
        card, f"dots {PROBE_DOT}", lambda: pd.dot_case(lhs, rhs, reps),
        lambda: pd.dot_case_plain(lhs, rhs, reps),
        lambda: torch.matmul(lhs_k, rhs_k), 2.0 * m * k * n * reps,
        2 * (m * k + rhs.numel() + m * n))}
    del lhs_k, rhs_k, lib
    # the same case with its planes streamed from L2: residency alone
    _probe_check("dots", pd.dot_case(lhs, rhs, reps, streamed=True),
                 pd.dot_case_plain(lhs, rhs, reps))
    streamed_ms = median_ms(lambda: pd.dot_case(lhs, rhs, reps, streamed=True))
    print(f"probe dots {PROBE_DOT}: planes streamed from L2 {streamed_ms:.3f} "
          f"ms against resident {fields['dots']['ms']:.3f} ms, same K "
          f"[{card}]", flush=True)
    m, c, n, reps = PROBE_ROWS
    for kind, wrapper, plain in (("rowpipe", pd.rowpipe, pd.rowpipe_plain),
                                 ("kstack", pd.kstack, pd.kstack_plain)):
        args = kc.rows_args(g, m, c, n, PROBE_NROWS)
        err = _probe_check(kind, wrapper(*args, reps, PROBE_NROWS),
                           plain(*args, reps, PROBE_NROWS))
        nbytes = sum(t.numel() * t.element_size() for t in args) + 2 * m * n
        fields[kind] = {"max_abs_err": err, **_probe_timing(
            card, f"{kind} {PROBE_ROWS}",
            lambda: wrapper(*args, reps, PROBE_NROWS),
            lambda: plain(*args, reps, PROBE_NROWS), None,
            2.0 * m * 9 * c * n * reps, nbytes)}
    try:
        pd.kstack(*args, PROBE_NROWS, PROBE_NROWS)
    except ValueError as e:
        print(f"kstack at reps = nrows refused: {e}", flush=True)
    else:
        raise AssertionError("kstack took reps = nrows")
    # the row pipeline with the same operations' weights split by input
    # channels over a cluster (m = 64, c = 256) instead of output channels
    args = kc.rows_args(g, 64, 256, n, PROBE_NROWS)
    _probe_check("rowpipe", pd.rowpipe(*args, reps, PROBE_NROWS),
                 pd.rowpipe_plain(*args, reps, PROBE_NROWS))
    split_ms = median_ms(lambda: pd.rowpipe(*args, reps, PROBE_NROWS))
    print(f"probe rowpipe (64, 256, {n}, {reps}): weights split by input "
          f"channels over a cluster of 4 {split_ms:.3f} ms against "
          f"{fields['rowpipe']['ms']:.3f} ms split by output channels at "
          f"{PROBE_ROWS}, same operations [{card}]", flush=True)
    h, w, c, nblk = PROBE_DMA
    ring, starts = kc.dma_args(np.random.RandomState(0), h, w, c, nblk, 6)
    ph, pw = pm.PATCHES["patch"]
    pwl = pw * c
    err = _probe_check("gather", pm.gather(ring, starts, ph, pwl),
                       pm.gather_plain(ring, starts, ph, pwl))
    st = starts.long().reshape(-1, 2)
    yi = st[:, 0, None, None] + torch.arange(ph, device="cuda")[:, None]
    xi = st[:, 1, None, None] + torch.arange(pwl, device="cuda")
    covered = covered_bytes(ring, yi, xi)
    moved = nblk * ph * pwl * 2   # the patches' bytes into shared memory
    timing, gather_warm = _probe_timing(
        card, f"gather {nblk} patches of ({ph}, {pwl}) "
        f"({moved / 1e6:.1f} MB, covering {covered / 1e6:.1f} "
        f"MB of the {ring.numel() * 2 / 1e6:.1f} MB ring {tuple(ring.shape)})",
        lambda r: pm.gather(r, starts, ph, pwl),
        lambda r: pm.gather_plain(r, starts, ph, pwl),
        lambda r: r[yi, xi], 0.0, covered + starts.numel() * 4 + 128 * 4,
        ring=ring, wrapper=pm.gather)
    fields["gather"] = {"max_abs_err": err, **timing}
    rows = pm.big_rows(h, w, nblk)
    err = _probe_check("big", pm.big(ring, starts, rows),
                       pm.big_plain(ring, starts, rows))
    y0 = min(max(int(starts[0]), 0), ring.shape[0] - rows)
    big_bytes = rows * ring.shape[1] * 2
    timing, big_warm = _probe_timing(
        card, f"big {rows} rows ({big_bytes / 1e6:.1f} MB)",
        lambda r: pm.big(r, starts, rows),
        lambda r: pm.big_plain(r, starts, rows),
        lambda r: r[y0:y0 + rows].clone(), 0.0,
        big_bytes + 4 + 128 * 4, ring=ring, wrapper=pm.big)
    fields["big"] = {"max_abs_err": err, **timing}
    # which floor the gather is against: its copies cross from L2 into the
    # SMs (every patch byte, overlaps included), beside the warm big copy
    print(f"probe gather: {moved / 1e6:.1f} MB from L2 into the SMs at "
          f"{moved / fields['gather']['ms'] / 1e9:.3f} TB/s (warm "
          f"{moved / gather_warm / 1e9:.3f}); the warm big copy "
          f"{big_bytes / big_warm / 1e9:.3f} TB/s [{card}]", flush=True)
    torch.cuda.empty_cache()
    return fields


def run_tools(card: str) -> dict:
    """Phase 6: the three trunk microbenchmarks at their default case lists
    (each case held against its plain version first, inside the tool);
    returns the launches of each of their kernels over the phase."""
    reset_launches()
    t0 = time.perf_counter()
    microbench_trunk.main([])
    for mode in ("dots", "rowpipe", "kstack"):
        microbench_dots.main(["--mode", mode])
    microbench_dma.main([])
    launches = {kind: wrapper.launches
                for kind, (_, wrapper, *_) in TOOL_KERNELS.items()}
    print(f"trunk microbenchmarks in {time.perf_counter() - t0:.1f} s, "
          f"kernel launches {launches} [{card}]", flush=True)
    missing = [kind for kind, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the tools never launched {missing}")
    return launches


def sdpa(kind, q, v):
    """The one PyTorch call computing the attention kernel's function
    (softmax(q q^T) v, no scale), timed as its library yardstick; the port
    never calls it. The column form attends along H of each (b, w)."""
    if kind == "column":
        q, v = q.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    return F.scaled_dot_product_attention(q, q, v, scale=1.0)


def check_kernels(card: str) -> dict:
    """Phase 3; returns the JSON fields of each wrapper, measured at the
    main path's shape in bfloat16, the dtype the fused EGLA gives the
    column stage (the unfused EGLA's 9-tap convs promote its row and column
    stages to float32)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    fields = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kind, shape in KERNEL_CASES:
            kernel, plain = WRAPPERS[kind]
            q, v = kc.attention_args(dtype, g, shape)
            out = kernel(q, v)
            ref = plain(q, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = kc.TOLERANCE[dtype] * scale
            line = (f"kernel {kind} {tuple(shape)} {str(dtype)[6:]}: "
                    f"max_abs_err {err:.3e} (max |plain| {scale:.3f}, "
                    f"rel {err / scale:.3e}, tolerance rel "
                    f"{kc.TOLERANCE[dtype]:.1e})")
            main = shape == KERNEL_CASES[0 if kind == "token" else 1][1]
            if main:
                ms = median_ms(lambda: kernel(q, v))
                plain_ms = median_ms(lambda: plain(q, v))
                library_ms = median_ms(lambda: sdpa(kind, q, v))
                bound_ms, bound_by = bound(kind, (q, v), out, dtype)
                line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                         f"scaled_dot_product_attention {library_ms:.3f} ms, "
                         f"bound {bound_ms:.3f} ms ({bound_by}) [{card}]")
                if dtype == torch.bfloat16:
                    fields[kind] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms,
                                    "bound_ms": bound_ms,
                                    "bound_by": bound_by,
                                    "library_ms": library_ms}
            print(line, flush=True)
            if not err <= tol:
                raise AssertionError(f"kernel disagrees with plain: {line}")
            del q, v, out, ref
    return fields


def seeded_model(cfg, device="cuda"):
    """CVSRV8 with the seeded weights every slice uses, the EGLA mask
    one-hot."""
    model = CVSRV8(cfg, generator=torch.Generator().manual_seed(0),
                   device=device)
    kc.excite_egla_mask(model)
    return model


@torch.inference_mode()
def mask_bits(eng, data, label: str) -> None:
    """Prints the EGLA mask's set bits per frame of the first step's
    ``compensate_frames`` call; raises unless each frame has one."""
    model = eng.model
    _, steps = eng.stage_sequence(data)
    rms = steps[0][0][2].to(model.cfg.compute_dtype)
    bits = model.RDAB.residual_mask(model.conv_expand_rms(rms)).sum(dim=1)
    bits = [int(b) for b in bits.tolist()]
    print(f"{label}: EGLA mask bits per frame of one compensate_frames call "
          f"{bits}", flush=True)
    if bits != [1] * len(bits):
        raise AssertionError(f"EGLA mask not one-hot: {bits}")


def check_small_slice(**flags):
    """Phase 4: card (kernels) vs CPU (plain versions), one set of
    weights. Under ``trunk_int8`` the CPU's plain version walks the
    kernel's step geometry (its default), so both compute one scheme."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(scn_groups=2, **flags)
    data = synthetic_sequence(t=9, h=16, w=24, seed=3)
    frames = {}
    for dev in ("cpu", "cuda"):
        eng = BatchedStreamingEngine(seeded_model(cfg, dev), k=4)
        frames[dev], _ = eng.run_sequence(data)
    mask_bits(eng, data, f"small slice {flags}")
    diff = np.abs(frames["cuda"].astype(np.int32)
                  - frames["cpu"].astype(np.int32))
    print(f"small slice (nf=64, 2 groups, 9x16x24, k=4, fp32, {flags}): "
          f"card vs CPU max diff {diff.max()} LSB over {diff.size} pixels",
          flush=True)
    if diff.max() > 1 or frames["cuda"].std() == 0:
        raise AssertionError("small-slice card output disagrees with CPU")


def run_full_slice(card: str, **flags):
    """Phase 5 for one setting of the fused flags; returns (frames, the
    launches per wrapper in the timed run)."""
    t, k = 12, 4
    cfg = ModelConfig(compute_dtype=torch.bfloat16, **flags)
    model = seeded_model(cfg)
    data = synthetic_sequence(t=t, h=272, w=480, seed=0)
    eng = BatchedStreamingEngine(model, k=k)
    mask_bits(eng, data, f"full slice {flags}")
    t0 = time.perf_counter()
    eng.run_sequence(data)   # warm-up: cuDNN/cuBLAS plans, allocator
    print(f"full slice {flags}: warm-up run "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, fps = eng.run_sequence(data, collect_timing=True)
    launches = path_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(range(0, t, k))
    calls = 1 + steps   # compensate_frames: bootstrap + one per step
    print(f"full slice (CVSR_V8 nf=64, 7 groups, bf16, 272x480 -> 1080x1920, "
          f"k={k}, {t} frames, {flags}): {fps:.3f} fps by the reference "
          f"protocol, peak memory {peak:.2f} GiB [{card}]", flush=True)
    print(f"compensate_frames calls {calls}, align_reconstruct calls {steps}, "
          f"kernel launches {launches}", flush=True)
    if frames.shape != (t, 1080, 1920) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")
    if frames.std() == 0:
        raise AssertionError("full-slice output is constant")
    want = path_launches(flags, calls, steps)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    if flags == PATH_AB:
        # the served mode: staging of step j+1 and the readback under the
        # card's work, frames equal to the timed mode's
        t0 = time.perf_counter()
        served, _ = eng.run_sequence(data)
        wall = time.perf_counter() - t0
        print(f"full slice {flags}: untimed run_sequence {t / wall:.3f} fps "
              f"by its wall time ({wall * 1e3:.1f} ms, inputs staged and "
              f"frames read back inside) against the timed {fps:.3f} fps "
              f"[{card}]", flush=True)
        if not np.array_equal(served, frames):
            raise AssertionError("untimed and timed frames differ")
    times, clipped = stage_times(eng, data)
    print(f"stage ms, one k={k} step {flags}: "
          + ", ".join(f"{n} {v:.3f}" for n, v in times.items())
          + f" [{card}]", flush=True)
    if clipped is not None:
        print(f"full slice {flags}: share of one trunk call's y values past "
              f"the lagged scale: y1 {clipped[0]:.3e}, y2 {clipped[1]:.3e}",
              flush=True)
    del model, eng
    torch.cuda.empty_cache()
    return frames, launches


def path_launch_counts() -> dict:
    """The model-path wrappers' launch counts."""
    launches = {"token": fa.token_self_attention.launches,
                "column": fa.column_self_attention.launches}
    launches.update({kind: wrapper.launches
                     for kind, (_, wrapper, *_) in ALL_KERNELS.items()})
    return launches


def path_launches(flags: dict, calls: int, steps: int) -> dict:
    """The launches of each model-path wrapper in an engine run with the
    fused ``flags``, ``calls`` ``compensate_frames`` and ``steps``
    ``align_reconstruct`` calls."""
    egla = flags.get("fused_egla", False)
    want = {"token": 0 if egla else calls, "column": calls}
    want.update({kind: n * calls if egla else 0
                 for kind, n in EGLA_LAUNCHES.items()})
    fused = flags.get("fused_trunk", False)
    int8 = flags.get("trunk_int8", False)
    want.update({kind: n * steps if fused else 0
                 for kind, n in TRUNK_LAUNCHES.items()})
    want["blockq"] = TRUNK_LAUNCHES["block"] * steps if int8 else 0
    want["block"] = 0 if int8 else want["block"]
    want["warp"] = steps if flags.get("block_warp") else 0
    want.update({kind: n * calls if flags.get("fused_embed") else 0
                 for kind, n in EMBED_LAUNCHES.items()})
    want.update({kind: n * steps if flags.get("fused_align") else 0
                 for kind, n in ALIGN_LAUNCHES.items()})
    return want


@torch.inference_mode()
def stage_times(eng, data, reps: int = 10):
    """ms per stage (CUDA events, median of ``reps``) of the first step of
    the staged sequence, each stage called alone through the model's own
    methods on that step's inputs, the rings as the step finds them; and,
    under ``trunk_int8``, the share of that step's trunk call's y1 and y2
    values past the lagged scale (else None)."""
    model = eng.model
    boot, steps = eng.stage_sequence(data)
    (ring_l1, ring_fi, ring_uf), _ = eng.run_staged(boot, [])
    (lrs, pms, rms, ufs, mvs, center_lr, idx, cidx), _ = steps[0]
    dt = model.cfg.compute_dtype
    center = ring_l1[cidx].to(dt)
    nbrs = model.warp_neighbours(ring_fi, ring_uf[idx], mvs, idx)
    aligned = model.align_neighbours(center, *nbrs)
    trunk_in = lrelu(model._tsa(aligned, center))
    trunk_out = model.recon_trunk(trunk_in)
    rms_prior = model.conv_expand_rms(rms.to(dt))
    egla_in = model.embed(lrs.to(dt), pms.to(dt)) + rms_prior
    stages = {
        "compensate_frames": lambda: model.compensate_frames(lrs, pms, rms,
                                                             ufs),
        "embed": lambda: model.embed(lrs.to(dt), pms.to(dt)),
        "EGLA": lambda: model.RDAB(rms_prior, egla_in),
        "align_reconstruct": lambda: model.align_reconstruct(
            center, center_lr, ring_fi, ring_uf[idx], mvs, idx),
        "warp_neighbours": lambda: model.warp_neighbours(
            ring_fi, ring_uf[idx], mvs, idx),
        "DualAttAlignment": lambda: model.align_neighbours(center, *nbrs),
        "tsa": lambda: model._tsa(aligned, center),
        "trunk": lambda: model.recon_trunk(trunk_in),
        "head": lambda: model.head_from_trunk(trunk_out, center_lr),
    }
    times = {name: median_ms(fn, reps) for name, fn in stages.items()}
    return times, (int8_clipped_share(model.recon_trunk, trunk_in)
                   if model.cfg.trunk_int8 else None)


def int8_clipped_share(trunk, x):
    """One call of the int8 trunk on ``x``, block by block with the
    kernel's clip counters on: (y1 values past the lagged scale / all y1
    values, the same for y2; the steps that hold them run again at their
    own amax)."""
    total = torch.zeros(2, dtype=torch.float64, device=x.device)
    blocks = 0
    skip = x.contiguous()
    for group in trunk.body:
        t = skip
        for block in group.body:
            params = block._params()
            t, clips = fq.scale_block_q(t, *params,
                                        packed=block._packed(t, params),
                                        clip_counts=True)
            total += clips
            blocks += 1
        skip = fg.grouptail(t, skip, group.conv.weight, group.conv.bias)
    n = blocks * x.numel()
    return total[0].item() / (4 * n), total[1].item() / (16 * n)


def profile_main_path(card: str, extra=(), top: int = 30):
    """``--profile``: the engine's timed region (bootstrap and every step of
    a 12-frame 272x480 sequence, inputs staged before it) of the main path
    (with the flags named in ``extra`` on as well) under
    ``torch.profiler``; prints the kernels by summed device time and the
    union of kernel intervals over the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    t, k = 12, 4
    flags = dict(ALL_FLAGS, **{name: True for name in extra})
    model = seeded_model(ModelConfig(compute_dtype=torch.bfloat16, **flags))
    data = synthetic_sequence(t=t, h=272, w=480, seed=0)
    eng = BatchedStreamingEngine(model, k=k)
    eng.run_sequence(data)   # warm-up
    boot, steps = eng.stage_sequence(data)
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_staged(boot, steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name][1] += 1
    busy, end = 0.0, None
    for a, b in spans:   # union of the kernel intervals, in us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    print(f"profiled main path {list(extra)} ({t} frames, k={k}, bf16, 272x480, "
          f"{len(spans)} device events): host wall {wall_ms:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / 1e3 / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / 1e3 / wall_ms:.1f}%) [{card}]", flush=True)
    total = sum(v[0] for v in by_name.values())
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% {n:5d}x  "
              f"{name[:110]}", flush=True)


# the PHASE marks of csrc/fused_block2_q.cu's steps (bf16), in order
INT8_PHASES = ("prologue: x window, z, amaxes, lagged scales, xq and us",
               "conv1 s8 products (4 chunks)",
               "conv1 quantizing epilogue (4 chunks)",
               "fold and conv2 s8 products (4 chunks)",
               "epilogue: fold + b2, kd, up2(e), output",
               "the step's amax reduction, listing a step past its scale",
               "waits at the chunks' two barriers")
# the PHASE marks of csrc/fused_tail.cu's bf16 walk, per step, in order
TAIL_PHASES = ("xm = x * gate (and a warm-up's zeroed windows)",
               "y1 = relu(conv11 xm)", "r1 = xm + conv12 y1",
               "y2 = relu(conv21 r1)", "out = r1 + conv22 y2 + centre",
               "the windows' last two rows to the top")
# the PHASE marks of csrc/fused_head.cu's bf16 walk, per step, in order
HEAD_PHASES = ("the wait for t's row at the step's barrier",
               "shift-add, x4 base and stores of the rows finished (half)",
               "stage 1 -> stage 2 -> taps on wgmma, z stores")
# the PHASE marks of csrc/fused_mdta.cu's bf16 stage-1 walk, per step
MDTA1_PHASES = ("the wait for x's row at the step's barrier", "LN1",
                "qkv and the last row's grams on wgmma, ring stores",
                "depthwise 3x3, q, k, v stores",
                "the proxy fence and barrier after LN1")
# the PHASE marks of csrc/fused_groupconv.cu's bf16 walk, per step
GROUP_PHASES = ("the wait for the step's rows at its barrier",
                "the conv's products", "epilogue: + b + skip, the store's issue")
# the PHASE marks of csrc/fused_mdta.cu's bf16 stage-2 walk, per step
MDTA2_PHASES = ("the wait for the step's rows at its barrier",
                "o = v A^T and the projection on wgmma",
                "t, LN2 and the ring stores",
                "the proxy fence and barrier before the conv",
                "the conv's products",
                "epilogue: + b + t + x2, the store's issue")
# the PHASE marks of csrc/fused_align.cu's bf16 stage-2 walk, per step
MSA2_PHASES = ("the wait for the step's stage at its mbarrier",
               "o = [w p] [awt; apt] on wgmma", "po = o W_proj on wgmma",
               "fo = po W_fA + q W_fB on wgmma",
               "epilogue: relu, sums, rounded fo to shared memory",
               "barrier, the store's and the next loads' issue, running sums")
# the PHASE marks of csrc/fused_align.cu's bf16 stage-1 walk, per step
MSA1_PHASES = ("the wait for the step's stage at its mbarrier",
               "k = [w p] W_f on wgmma beside the sums of w and p",
               "k: relu, rounded in place of w",
               "the grams q^T [k | q] and k^T k on wgmma",
               "barrier, a centre's flush, the next loads' issue")
# the PHASE marks of csrc/fused_egla.cu's bf16 eg2 walk, per step
EG2_PHASES = ("the wait for the step's stage at its mbarrier",
              "q = x wq, v = x wv on wgmma",
              "their epilogue: biases, mask, q and v tiles",
              "s = q q^T on wgmma", "softmax, p rounded",
              "loc = p v, out = long fa + loc fb on wgmma",
              "epilogue: + bf + x, barrier, the stores' and loads' issue")
# the PHASE marks of csrc/fused_egla.cu's bf16 eg1 walks, per step: the
# projection and band walk's, then (-DCDFO_PHASE_ROWS) the row attention's
EG1_WALK_PHASES = ("the wait for x's rows at the step's barrier",
                   "q_s and v on wgmma", "their epilogue: ring and v rows",
                   "the band, the stores' issue")
EG1_ROWS_PHASES = ("the wait for the row's K", "Q K^T on wgmma",
                   "mask, row max and its exchange",
                   "exp, row sum and its exchange, p to bf16",
                   "the wait for the row's V, P.V on wgmma",
                   "warpgroup 1's half, v_r rounded, the store's issue")
# the PHASE marks of csrc/fused_block2.cu's bf16 route, in order
EXACT_PHASES = ("prologue", "conv1 and the y stores (4 chunks)",
                "fold and conv2 with the sums (4 chunks)", "epilogue")
# the PHASE marks of csrc/warp_block.cu's bf16 kernel, per block of a
# warp (lane 0 of warp 0's view; the first mark once a warp)
WARP_PHASES = ("the blocks' flows, paths and TMA issue (once a warp)",
               "the wait for the block's patch (patch path)",
               "blend and stores (per-pixel path: its taps too)")
# the PHASE marks of csrc/fused_block.cu's bf16 cluster walk, per step, in
# warpgroup 0's view (thread 0: conv1) and warpgroup 1's (thread 128:
# conv2's partial and the sums)
BODY_PHASES = ("warpgroup 0: x's loads, the wait for x's rows; warpgroup "
               "1: the residual's loads, the wait for y1's rows",
               "the products' issue, the wait for the last step's barrier; "
               "warpgroup 1: the last partials' sends",
               "the last step's epilogue under the products: warpgroup 0 "
               "y1's row stores, warpgroup 1 the wait for the partials, "
               "their sum and stores",
               "the wait for the products",
               "the arrival at the step's barrier")


@torch.no_grad()
def phase_clocks(card: str, label: str, source: str, symbol: str, nargs,
                 args, res, check, names, defines=()):
    """``--phases``: compiles ``csrc/<source>.cu`` once more with
    ``-DCDFO_PHASE_CLOCKS``, launches ``symbol(*args, stream)`` (``nargs``
    pointers, then ints, as ``args`` gives them, or ``nargs`` the ctypes
    argument types; ``res`` its output, which ``check(res)`` holds against
    the plain version), and prints the cycles
    thread 0 of a CTA spends between the kernel's phase marks
    (``csrc/phase_clocks.cuh``), averaged over the steps the launch's CTAs
    ran, as the kernel counts them, or over its CTAs where it counts none
    (a warp's own view: its waits at barriers count where it waits).
    ``defines``: further -D flags (which of a source's kernels is
    marked)."""
    out = cuda_build.BUILD_DIR / f"{source}{''.join(defines)}-phase-clocks.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                    "-DCDFO_PHASE_CLOCKS", *defines, "-o", str(out),
                    str(cuda_build.CSRC / f"{source}.cu")],
                   check=True, capture_output=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    kernel = getattr(lib, symbol)
    if isinstance(nargs, int):
        nargs = ([ctypes.c_void_p] * nargs
                 + [ctypes.c_int] * (len(args) - nargs))
    kernel.argtypes = [*nargs, ctypes.c_void_p]
    clocks = (ctypes.c_longlong * 16)()

    def launch():
        err = kernel(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"phase-clock launch failed: CUDA error {err}")

    ms = median_ms(launch)
    check(res)
    lib.cdfo_phase_clocks_read(clocks)
    launch()
    torch.cuda.synchronize()
    if lib.cdfo_phase_clocks_read(clocks) != 0 or clocks[15] == 0:
        raise RuntimeError("could not read the phase clocks")
    steps, ctas = clocks[14], clocks[15]
    per = steps or ctas
    total = sum(clocks[:len(names)])
    print(f"{label} with phase clocks bf16: {ms:.3f} ms a call; cycles per "
          f"{'step' if steps else 'CTA'}, averaged over "
          f"{f'{steps} steps of ' if steps else ''}{ctas} CTAs "
          f"({total / per:.0f} in all) [{card}]", flush=True)
    for name, c in zip(names, clocks):
        print(f"  {c / per:9.0f} {100 * c / total:5.1f}%  {name}", flush=True)


PHASE_KINDS = ("blockq", "block", "tail", "head", "mdta1", "group", "mdta2",
               "msa1", "msa2", "eg1", "eg2", "warp", "body")


def run_phase_clocks(card: str, kinds=PHASE_KINDS):
    """``--phases`` for the int8 ``Block_``, the exact one, the alignment
    tail, the head, the group tail, both MDTA passes, both dual-MSA passes,
    eg1's two walks, eg2, the block warp and the body pair at the main
    shapes in bfloat16, their weights packed once; ``kinds``: those of
    ``PHASE_KINDS`` to run."""
    if "warp" in kinds:
        phase_clocks_warp(card)
    if "body" in kinds:
        phase_clocks_body(card)
    if "msa1" in kinds:
        phase_clocks_msa1(card)
    if "msa2" in kinds:
        phase_clocks_msa2(card)
    if "eg1" in kinds:
        phase_clocks_eg1(card)
    if "eg2" in kinds:
        phase_clocks_eg2(card)
    if "blockq" in kinds:
        g = torch.Generator(device="cuda").manual_seed(4)
        x, *params = kc.trunk_args("blockq", torch.bfloat16, g, TRUNK_MAIN)
        packed = fq.pack_weights_q(*params, torch.bfloat16)
        res = torch.empty_like(x)
        b, h, w, c = x.shape
        e = torch.empty(b, h // 2, w // 2, c, dtype=x.dtype, device="cuda")
        redo = torch.empty(1 + 5 * b * -(-h // 8) * -(-w // 8),
                           dtype=torch.int32, device="cuda")
        phase_clocks(
            card, f"int8 Block_ {tuple(x.shape)} (the walk)", "fused_block2_q",
            "cdfo_fused_block2_q", 20,
            [x.data_ptr(), *fb.pointers(packed), res.data_ptr(), None,
             e.data_ptr(), redo.data_ptr(), 1, b, h, w], res,
            lambda r: kc.assert_outputs_close(
                r, fq.scale_block_q_plain(x, *params), torch.bfloat16,
                "blockq"),
            INT8_PHASES)
    if "block" in kinds:
        g = torch.Generator(device="cuda").manual_seed(1)
        x, *params = kc.trunk_args("block", torch.bfloat16, g, TRUNK_MAIN)
        packed = fb.pack_weights(*params, torch.bfloat16)
        res = torch.empty_like(x)
        phase_clocks(
            card, f"exact Block_ {tuple(x.shape)}", "fused_block2",
            "cdfo_fused_block2", 11,
            [x.data_ptr(), *fb.pointers(packed), res.data_ptr(), 1,
             *x.shape[:3]], res,
            lambda r: kc.assert_outputs_close(
                r, fb.scale_block_plain(x, *params), torch.bfloat16, "block"),
            EXACT_PHASES)
    if "tail" in kinds:
        g = torch.Generator(device="cuda").manual_seed(1)
        args = kc.trunk_args("tail", torch.bfloat16, g, TRUNK_MAIN, nbr=6)
        packed = ft.pack_tail_weights(args[3::2], args[4::2], torch.bfloat16)
        res = torch.empty_like(args[0])
        b, h, w, _ = args[0].shape
        phase_clocks(
            card, f"alignment tail {tuple(args[0].shape)}", "fused_tail",
            "cdfo_fused_tail", 6,
            [*(t.data_ptr() for t in args[:3]), *fb.pointers(packed),
             res.data_ptr(), 1, b, h, w, b // args[1].shape[0]], res,
            lambda r: kc.assert_outputs_close(
                r, ft.resblock_pair_plain(*args), torch.bfloat16, "tail"),
            TAIL_PHASES)
    if "head" in kinds:
        g = torch.Generator(device="cuda").manual_seed(1)
        args = kc.trunk_args("head", torch.bfloat16, g, TRUNK_MAIN)
        packed = fh.pack_head_weights(*args[2:7], torch.bfloat16)
        b, h, w, _ = args[0].shape
        res = torch.empty(b, 4 * h, 4 * w, 1, device="cuda")
        phase_clocks(
            card, f"head {tuple(args[0].shape)}", "fused_head",
            "cdfo_fused_head",
            9, [args[0].data_ptr(), args[1].data_ptr(), *fb.pointers(packed),
                args[7].data_ptr(), res.data_ptr(), 1, b, h, w], res,
            lambda r: kc.assert_outputs_close(
                r, fh.fused_head_plain(*args), torch.bfloat16, "head"),
            HEAD_PHASES)
    if "mdta1" in kinds:
        g = torch.Generator(device="cuda").manual_seed(2)
        shape = ALIGN_EMBED_SHAPES[0][0]
        x, lnw, lnb, wq, wdw = kc.align_embed_args("mdta1", torch.bfloat16, g,
                                                   shape, 6)
        wk, taps = fm.pack_stage1_weights(wq, wdw, torch.bfloat16)
        v = torch.empty_like(x)
        stats = torch.empty(shape[0], 3, 64, 64, device="cuda")
        ws = cuda_build.workspace(fm._kernel("cdfo_mdta_stage1_workspace"),
                                  "mdta1", x.device, *shape, 1)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        phase_clocks(
            card, f"MDTA stage 1 {tuple(x.shape)}", "fused_mdta",
            "cdfo_mdta_stage1", [ptr] * 7 + [i32, ptr] + [i32] * 4,
            [*(t.data_ptr() for t in (x, lnw, lnb, wk, taps, v, ws)),
             ws.numel(),
             stats.data_ptr(), 1, *shape], (v, stats),
            lambda r: kc.assert_outputs_close(
                r, fm.mdta_stage1_plain(x, lnw, lnb, wq, wdw), torch.bfloat16,
                "mdta1"),
            MDTA1_PHASES)
    if "group" in kinds:
        g = torch.Generator(device="cuda").manual_seed(1)
        args = kc.trunk_args("group", torch.bfloat16, g, TRUNK_MAIN)
        wk = fg.pack_grouptail_weights(args[2], torch.bfloat16)
        res = torch.empty_like(args[0])
        phase_clocks(
            card, f"group tail {TRUNK_MAIN}", "fused_groupconv",
            "cdfo_grouptail",
            5, [args[0].data_ptr(), args[1].data_ptr(), wk.data_ptr(),
                args[3].data_ptr(), res.data_ptr(), 1, *TRUNK_MAIN[:3]], res,
            lambda r: kc.assert_outputs_close(
                r, fg.grouptail_plain(*args), torch.bfloat16, "group"),
            GROUP_PHASES)
    if "mdta2" in kinds:
        g = torch.Generator(device="cuda").manual_seed(2)
        shape = ALIGN_EMBED_SHAPES[0][0]
        args = kc.align_embed_args("mdta2", torch.bfloat16, g, shape, 6)
        pk, ck = fm.pack_stage2_weights(args[4], args[7], torch.bfloat16)
        res = torch.empty_like(args[0])
        phase_clocks(
            card, f"MDTA stage 2 {tuple(args[0].shape)}", "fused_mdta",
            "cdfo_mdta_stage2", 10,
            [*(t.data_ptr() for t in args[:4]), pk.data_ptr(),
             args[5].data_ptr(), args[6].data_ptr(), ck.data_ptr(),
             args[8].data_ptr(), res.data_ptr(), 1, *shape], res,
            lambda r: kc.assert_outputs_close(
                r, fm.mdta_stage2_plain(*args), torch.bfloat16, "mdta2"),
            MDTA2_PHASES)


def phase_clocks_warp(card: str):
    """``--phases`` of the block warp's bf16 walk at the main path's 24
    neighbour images of a ring of 8 frames, blocky flows: bit for bit its
    plain version's."""
    g = torch.Generator(device="cuda").manual_seed(5)
    ring, idx, flow = kc.warp_args("blocky", torch.bfloat16, g, WARP_MAIN)
    idx32 = idx.to(torch.int32)
    res = torch.empty(*flow.shape[:3], 64, dtype=ring.dtype, device="cuda")

    def check(r):
        if not torch.equal(r, wb.flow_warp_ring_block_plain(ring, idx, flow)):
            raise AssertionError("the phase-clock warp differs from plain")

    phase_clocks(
        card, f"block warp {WARP_MAIN} (blocky)", "warp_block",
        "cdfo_warp_block", 5,
        [ring.data_ptr(), idx32.data_ptr(), flow.data_ptr(), res.data_ptr(),
         None, 1, *WARP_MAIN], res, check, WARP_PHASES)


def phase_clocks_body(card: str):
    """``--phases`` of the body pair's bf16 cluster walk at the main shape,
    its weights packed once."""
    g = torch.Generator(device="cuda").manual_seed(6)
    args = kc.body_args(torch.bfloat16, g, TRUNK_MAIN)
    x, w1, b1, w2, b2 = args
    packed = fbody.pack_body_weights(w1, w2, torch.bfloat16)
    res = torch.empty_like(x)
    for view, thread in (("warpgroup 0", 0), ("warpgroup 1", 128)):
        phase_clocks(
            card, f"Block_ body pair {TRUNK_MAIN} ({view}'s view)",
            "fused_block", "cdfo_fused_block", 6,
            [x.data_ptr(), packed.data_ptr(), b1.data_ptr(), None,
             b2.data_ptr(), res.data_ptr(), 1, *TRUNK_MAIN[:3], 1], res,
            lambda r: kc.assert_outputs_close(
                r, fbody.block_body_plain(*args), torch.bfloat16, "body"),
            BODY_PHASES, defines=(f"-DCDFO_PHASE_THREAD={thread}",))


def phase_clocks_msa1(card: str):
    """``--phases`` of dual-MSA stage 1's bf16 walk at the main path's 24
    neighbours of 4 centres."""
    g = torch.Generator(device="cuda").manual_seed(2)
    shape, nbr = ALIGN_EMBED_SHAPES[0]
    args = kc.align_embed_args("msa1", torch.bfloat16, g, shape, nbr)
    w, p, center, w_fuse = args
    b = w.shape[0]
    stats = torch.empty(b, 3, 64, 64, device="cuda")
    gaps = torch.empty(b, 2, 64, device="cuda")
    ws = cuda_build.workspace(fal._kernel("cdfo_msa_stage1_workspace"),
                              "msa1", w.device, b, *shape[1:], nbr, 1)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    phase_clocks(
        card, f"dual-MSA stage 1 {tuple(w.shape)}", "fused_align",
        "cdfo_msa_stage1", [ptr] * 5 + [i32] + [ptr] * 2 + [i32] * 5,
        [*(t.data_ptr() for t in (w, p, center, w_fuse, ws)), ws.numel(),
         stats.data_ptr(), gaps.data_ptr(), 1, b, *shape[1:], nbr],
        (stats, gaps),
        lambda r: kc.assert_outputs_close(
            r, fal.msa_stage1_plain(*args), torch.bfloat16, "msa1"),
        MSA1_PHASES)


def phase_clocks_msa2(card: str):
    """``--phases`` of dual-MSA stage 2's bf16 walk at the main path's 24
    neighbours of 4 centres, W_proj and W_fuse packed once."""
    g = torch.Generator(device="cuda").manual_seed(2)
    shape, nbr = ALIGN_EMBED_SHAPES[0]
    args = kc.align_embed_args("msa2", torch.bfloat16, g, shape, nbr)
    w, p, center, awt, apt, w_proj, w_fuse = args
    pk, fk = fal.pack_stage2_weights(w_proj, w_fuse, torch.bfloat16)
    ak = fal.pack_stage2_images(awt, apt, torch.bfloat16)
    b = w.shape[0]
    fo = torch.empty_like(w)
    gap = torch.empty(b, 64, device="cuda")
    ws = cuda_build.workspace(fal._kernel("cdfo_msa_stage2_workspace"),
                              "msa2", w.device, b, *shape[1:], nbr, 1)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    phase_clocks(
        card, f"dual-MSA stage 2 {tuple(w.shape)}", "fused_align",
        "cdfo_msa_stage2", [ptr] * 8 + [i32, ptr] + [i32] * 5,
        [*(t.data_ptr() for t in (w, p, center, ak, pk, fk, fo, ws)),
         ws.numel(), gap.data_ptr(), 1, b, *shape[1:], nbr], (fo, gap),
        lambda r: kc.assert_outputs_close(
            r, fal.msa_stage2_plain(*args), torch.bfloat16, "msa2"),
        MSA2_PHASES)


def phase_clocks_eg1(card: str):
    """``--phases`` of eg1's two bf16 walks at the main shape, each in a
    build of its own (the projection and band walk's marks, then the row
    attention's)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    args = kc.egla_args("eg1", torch.bfloat16, g, EGLA_MAIN)
    x, aq, cq, bv, cv, h9 = args
    aqk, bvk = fe.pack_eg1_weights(aq, bv, torch.bfloat16)
    qs, v, qc, vr = (torch.empty_like(x) for _ in range(4))
    for label, defines, names in (
            ("projection and band walk", (), EG1_WALK_PHASES),
            ("row attention", ("-DCDFO_PHASE_ROWS",), EG1_ROWS_PHASES)):
        phase_clocks(
            card, f"eg1 {EGLA_MAIN} ({label})", "fused_egla", "cdfo_eg1_rows",
            10, [*(t.data_ptr() for t in (x, aqk, cq, bvk, cv, h9, qs, v, qc,
                                          vr)), 1, *EGLA_MAIN[:3]], (qc, vr),
            lambda r: kc.assert_outputs_close(
                r, fe.eg1_rows_plain(*args), torch.bfloat16, "eg1"),
            names, defines)


def phase_clocks_eg2(card: str):
    """``--phases`` of eg2's bf16 window walk at the main shape."""
    g = torch.Generator(device="cuda").manual_seed(3)
    args = kc.egla_args("eg2", torch.bfloat16, g, EGLA_MAIN)
    out = torch.empty_like(args[0])
    phase_clocks(
        card, f"eg2 {EGLA_MAIN} (the window walk)", "fused_egla",
        "cdfo_eg2_local_fuse", 11,
        [*(t.data_ptr() for t in (*args, out)), 1, *EGLA_MAIN[:3]], out,
        lambda r: kc.assert_outputs_close(
            r, fe.eg2_local_fuse_plain(*args), torch.bfloat16, "eg2"),
        EG2_PHASES)


def redesign_order(card: str, fields: dict, launches: dict) -> None:
    """The kernels on a model path by launches x (time - bound) per
    12-frame run (each kernel's launches from the run of its own path,
    its time as phase 3 measured it for the JSON line): the order in which
    a redesign gains most."""
    loss = {kind: launches[kind] * (fields[kind]["ms"] - fields[kind]["bound_ms"])
            for kind in ("token", "column", *ALL_KERNELS)}
    print("redesign order, launches x (time - bound) per 12-frame run: "
          + ", ".join(f"{kind} {launches[kind]} x ({fields[kind]['ms']:.3f} - "
                      f"{fields[kind]['bound_ms']:.3f}) = {v:.1f} ms"
                      for kind, v in sorted(loss.items(), key=lambda kv: -kv[1]))
          + f" [{card}]", flush=True)


# -- phase 7: training ----------------------------------------------------------

# the LD preset's shapes of the four kernels training runs: batch 20 of 64x64
# crops for the Block_, the group tail and the head; EGLA over the batch's
# 120 neighbour images (rows of 7680 tokens, columns of 120 images)
TRAIN_TRUNK = (20, 64, 64, 64)
TRAIN_ATTENTION = (("token", (7680, 64, 64)), ("column", (120, 64, 64, 64)))
# kernel launches of one training step's forward at 7 trunk groups; the
# backward launches none
TRAIN_LAUNCHES = {"token": 1, "column": 1, "block": 21, "group": 7,
                  "head": 1}
TRAIN_STEPS = (2, 5)   # warm-up steps, timed steps


def launch_counts() -> dict:
    counts = {"token": fa.token_self_attention.launches,
              "column": fa.column_self_attention.launches}
    counts.update({kind: w.launches for kind, (_, w, *_) in
                   {**ALL_KERNELS, **TOOL_KERNELS}.items()})
    return counts


@torch.no_grad()
def check_training_kernels(card: str) -> None:
    """Phase 7(a): the four trained kernels' forwards against their plain
    versions at the LD preset's shapes, in float32 and bfloat16, with phase
    3's slices and tolerances."""
    check_kernel_table(card, {k: TRUNK_KERNELS[k] for k in
                              ("block", "group", "head")},
                       [(f"LD {TRAIN_TRUNK}", False,
                         lambda kind, dtype, g: kc.trunk_args(
                             kind, dtype, g, TRAIN_TRUNK))], seed=7)
    g = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for kind, shape in TRAIN_ATTENTION:
            kernel, plain = WRAPPERS[kind]
            q, v = kc.attention_args(dtype, g, shape)
            out, ref = kernel(q, v), plain(q, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            line = (f"kernel {kind} LD {shape} {str(dtype)[6:]}: max_abs_err "
                    f"{err:.3e} (max |plain| {scale:.3f}, rel "
                    f"{err / scale:.3e}, tolerance rel "
                    f"{kc.TOLERANCE[dtype]:.1e})")
            print(line, flush=True)
            if not err <= kc.TOLERANCE[dtype] * scale:
                raise AssertionError(f"kernel disagrees with plain: {line}")


def small_batches(seed: int, b: int = 2, h: int = 16, w: int = 24):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        lrs, pms, rms, ufs = (r.rand(b, 7, h, w, 1).astype(np.float32)
                              for _ in range(4))
        mvs = (r.randn(b, 7, h, w, 2) * 1.5).astype(np.float32)
        out.append({"lrs": lrs, "mvs0": mvs, "mvs1": mvs, "pms": pms,
                    "rms": rms, "ufs": ufs,
                    "hr": r.rand(b, 4 * h, 4 * w, 1).astype(np.float32)})
    return out


def train_two_steps(device: str, fused: bool, batches, u):
    """Two train steps of a float32 CVSR_V8 (nf 64, 2 trunk groups, the
    sampled mask, gumbel draw ``u``) from seeded weights on ``device``:
    (losses, the first step's gradients, the parameters after), on the
    CPU."""
    cfg = ModelConfig(scn_groups=2, mask_mode="sample", fused_trunk=fused)
    model = CVSRV8(cfg, torch.Generator().manual_seed(0), device=device)
    state = TrainState(model, TrainConfig())
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}
    apply = state.apply_gradients

    def record():
        if not grads:
            grads.update({names[id(p)]: p.grad.detach().float().cpu()
                          for p in state.params if p.grad is not None})
        apply()

    state.apply_gradients = record
    losses = [train_step(state, b, gumbel_u=u.to(device)).item()
              for b in batches]
    params = {n: p.detach().float().cpu()
              for n, p in model.state_dict().items()}
    return losses, grads, params


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def check_small_training(fused: bool) -> None:
    """Phase 7(b): two steps on the card (kernels) against the same on the
    CPU (plain versions): same weights, batches and gumbel u (drawn on the
    CPU). Loss within 1e-4 relative, each gradient and each parameter
    after the second step within 1e-3 relative L2: Adam moves each weight
    by about lr whatever its gradient's size, so a weight whose gradient
    is near zero takes the rounding's sign and size, and a tensor's
    parameters part by ~10x its gradients' relative error (on an H100:
    gradients 2.6e-5, parameters 2.7e-4, unfused)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = small_batches(11)
    u = torch.rand((2 * 6, 16, 24, 64), generator=torch.Generator()
                   .manual_seed(5)).clamp_min(torch.finfo(torch.float32).tiny)
    cpu = train_two_steps("cpu", fused, batches, u)
    reset_launches()
    card = train_two_steps("cuda", fused, batches, u)
    torch.cuda.synchronize()
    launches = launch_counts()
    label = f"small training (nf=64, 2 groups, 2x7x16x24, fp32, fused_trunk={fused})"
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    if set(card[1]) != set(cpu[1]):
        raise AssertionError(f"{label}: gradients of other parameters")
    grad_err = max((rel_l2(card[1][n], g), n) for n, g in cpu[1].items()
                   if g.norm() > 0)
    zero = [n for n, g in cpu[1].items() if g.norm() == 0
            and card[1][n].norm() > 0]
    param_err = max((rel_l2(card[2][n], p), n) for n, p in cpu[2].items())
    print(f"{label}: card vs CPU losses {card[0]} / {cpu[0]} (rel "
          f"{loss_err:.3e}); worst gradient rel L2 {grad_err[0]:.3e} "
          f"({grad_err[1]}); worst parameter after 2 Adam steps rel L2 "
          f"{param_err[0]:.3e} ({param_err[1]}); launches {launches}",
          flush=True)
    if not (loss_err <= 1e-4 and grad_err[0] <= 1e-3 and not zero
            and param_err[0] <= 1e-3):
        raise AssertionError(f"{label}: card disagrees with CPU ({zero})")
    want = {k: 0 for k in launches}
    want.update(token=2, column=2)
    if fused:
        want.update(block=12, group=4, head=2)
    if launches != want:
        raise AssertionError(f"{label}: expected launches {want}, got "
                             f"{launches}")


def snapshot(state) -> tuple:
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            [m.detach().clone() for m in state.masters],
            copy.deepcopy(state.optimizer.state_dict()), state.step)


def same_state(a: tuple, b: tuple) -> bool:
    return (all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
            and a[3] == b[3] and _same_tree(a[2], b[2]))


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b.to(a.device))
    return a == b


def run_training(card: str, root: str, ckpt: str, fused: bool):
    """Phase 7(c): the LD preset through ``train_loop`` (nf 64, 7 trunk
    groups, 7 frames, batch 20, 64x64 crops, the sampled mask, bf16 with
    float32 masters), 2 warm-up and 5 timed steps, one epoch, a checkpoint
    at its end. Checks each step's launches (forward ``TRAIN_LAUNCHES``
    with ``fused_trunk``, backward none) and finite losses; returns (the
    final state, the first loss, s/step, peak GiB, forward launches per
    step)."""
    warm, timed = TRAIN_STEPS
    model_cfg = ModelConfig(mask_mode="sample", fused_trunk=fused,
                            compute_dtype=torch.bfloat16)
    data_cfg = DataConfig(coding_cfg="LD", qp=37, frames_per_seq=10)
    train_cfg = TrainConfig(ckpt_dir=ckpt, val_interval=1)
    forward, steps, times = [], [], []

    def on_start(state):
        state.model.register_forward_pre_hook(lambda m, a: reset_launches())
        state.model.register_forward_hook(
            lambda m, a, out: forward.append(launch_counts()))
        torch.cuda.synchronize()
        times.append(time.perf_counter())

    def on_step(state, loss):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        if len(times) == warm + 1:
            torch.cuda.reset_peak_memory_stats()
        total = launch_counts()
        steps.append((forward[-1], {k: total[k] - forward[-1][k]
                                    for k in total}, loss.item()))

    state = train_loop(model_cfg, data_cfg, train_cfg, root, num_epochs=1,
                       steps_per_epoch=warm + timed, device="cuda",
                       on_start=on_start, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = (times[-1] - times[warm]) / timed
    label = (f"LD training (CVSR_V8 nf=64, 7 groups, 7 frames, batch 20, "
             f"64x64 crops, sampled mask, bf16 + fp32 masters, "
             f"fused_trunk={fused})")
    want = {k: 0 for k in steps[0][0]}
    if fused:
        want.update(TRAIN_LAUNCHES)
    else:
        want.update(token=1, column=1)
    for i, (fwd, bwd, loss) in enumerate(steps):
        if fwd != want or any(bwd.values()) or not math.isfinite(loss):
            raise AssertionError(f"{label} step {i}: loss {loss}, forward "
                                 f"launches {fwd} (want {want}), backward "
                                 f"{bwd}")
    print(f"{label}: losses {[round(s[2], 3) for s in steps]}; "
          f"{per_step:.4f} s/step, {20 / per_step:.2f} samples/s over "
          f"{timed} steps after {warm}, peak memory {peak:.2f} GiB; "
          f"launches per step forward {steps[0][0]}, backward none [{card}]",
          flush=True)
    return state, steps[0][2], per_step, peak, want


def step_breakdown(card: str, state, label: str, reps: int = 3) -> None:
    """Where one LD training step's time goes: the forward (with the loss),
    the backward and the optimizer's update, each closed by a
    synchronize, on one seeded batch; medians of ``reps`` after one
    warm-up step. The steps advance ``state``."""
    r = np.random.RandomState(3)
    b, n, h, w = 20, 7, 64, 64
    lrs, pms, rms, ufs = (r.rand(b, n, h, w, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(b, n, h, w, 2) * 0.05).astype(np.float32)
    batch = state.batch_to_device({
        "lrs": lrs, "mvs0": mvs, "mvs1": np.zeros_like(mvs), "pms": pms,
        "rms": rms, "ufs": ufs,
        "hr": r.rand(b, 4 * h, 4 * w, 1).astype(np.float32)})
    gen = torch.Generator(device=state.device).manual_seed(1)
    parts = collections.defaultdict(list)
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr, _ = state.model(*model_inputs(batch), generator=gen)
        loss = charbonnier_loss(sr, batch["hr"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in (("forward", t1 - t0), ("backward", t2 - t1),
                     ("update", t3 - t2)):
            parts[k].append(1e3 * v)
    print(f"{label}: one step's ms (median of {reps}) "
          + ", ".join(f"{k} {np.median(v[1:]):.1f}" for k, v in parts.items())
          + f" [{card}]", flush=True)


def check_resume(root: str, ckpt: str, before: tuple) -> None:
    """Phase 7(c): a new loop on the same directory resumes from the last
    checkpoint with the parameters, masters, optimizer state and step it
    held, then takes its next step."""
    seen, losses = [], []
    model_cfg = ModelConfig(mask_mode="sample", fused_trunk=True,
                            compute_dtype=torch.bfloat16)
    state = train_loop(
        model_cfg, DataConfig(coding_cfg="LD", qp=37, frames_per_seq=10),
        TrainConfig(ckpt_dir=ckpt, val_interval=1), root,
        num_epochs=before[3] + 1, steps_per_epoch=1, device="cuda",
        on_start=lambda s: seen.append(same_state(snapshot(s), before)),
        on_step=lambda s, loss: losses.append(loss.item()))
    print(f"resume: state equal to the saved one {seen}, next step loss "
          f"{losses}, step {state.step}", flush=True)
    if seen != [True] or len(losses) != 1 or not math.isfinite(losses[0]) \
            or state.step != before[3] + 1:
        raise AssertionError("the checkpoint did not resume")


def check_training(card: str) -> dict:
    """Phase 7; returns the training launches per step of each kernel."""
    check_training_kernels(card)
    for fused in (False, True):
        check_small_training(fused)
    codec = ("cv2" if data_io.cv2 else "PIL" if data_io.Image
             else "the standard-library PNG codec (data/png.py)")
    print(f"training data: images written and read through {codec}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="cdfo_train_") as tmp:
        root = os.path.join(tmp, "cvcp")
        data_io.make_synthetic_cvcp_tree(root, num_seqs=2, frames=10, h=64,
                                         w=96)
        state, first, per_step, peak, launches = run_training(
            card, root, os.path.join(tmp, "fused"), fused=True)
        saved = snapshot(state)
        step_breakdown(card, state, "LD training fused_trunk=True")
        del state
        check_resume(root, os.path.join(tmp, "fused"), saved)
        del saved
        torch.cuda.empty_cache()
        state, plain_first, plain_step, plain_peak, _ = run_training(
            card, root, os.path.join(tmp, "unfused"), fused=False)
        step_breakdown(card, state, "LD training fused_trunk=False")
        del state
        torch.cuda.empty_cache()
    rel = abs(first - plain_first) / abs(plain_first)
    print(f"LD training fused vs unfused: first-step loss {first:.4f} / "
          f"{plain_first:.4f} (rel {rel:.3e}); {per_step:.4f} / "
          f"{plain_step:.4f} s/step, {20 / per_step:.2f} / "
          f"{20 / plain_step:.2f} samples/s, peak {peak:.2f} / "
          f"{plain_peak:.2f} GiB [{card}]", flush=True)
    if not rel <= 1e-2:
        raise AssertionError("fused and unfused first-step losses differ")
    return launches


# -- phase 8: evaluation ------------------------------------------------------

# the JCT-VC LR geometries that no other phase runs (`tools/eval_jctvc.py:
# 20-31`), and one eval sequence of each
EVAL_GEOMETRIES = ((400, 640), (184, 320))
EVAL_SEQUENCES = ("Traffic_640x400_300F.yuv", "Johnny_320x184_600F.yuv")
EVAL_FRAMES = 8
# the model-path kernels (#1-#12 of PERF.md; the attention apart)
MODEL_PATH_KERNELS = {k: v for k, v in ALL_KERNELS.items() if k != "warp"}


def window_launches(flags: dict) -> dict:
    """Kernel launches of one per-window ``CVSRV8.forward`` (1 new frame
    embedded, or the first window's 7 in one call; EGLA over the 6
    neighbours; the trunk and head of 1 centre) at 7 trunk groups. As in
    cdfo_tpu's ``__call__``, the forward keeps the plain dual MSA and
    alignment tail: those kernels run in the engine's
    ``align_reconstruct`` only."""
    want = {k: 0 for k in launch_counts()}
    if flags.get("fused_egla"):
        want.update(column=1, **EGLA_LAUNCHES)
    else:
        want.update(token=1, column=1)
    if flags.get("fused_embed"):
        want.update(EMBED_LAUNCHES)
    if flags.get("fused_trunk"):
        want.update(block=21, group=7, head=1)
    if flags.get("trunk_int8"):
        want.update(block=0, blockq=21)
    return want


@torch.no_grad()
def check_eval_kernels(card: str) -> None:
    """Phase 8(a): every model-path kernel against its plain version in
    bfloat16, phase 3's slices and tolerances, at the two JCT-VC
    geometries, at the engine's k = 4 shapes (4 frames embedded and
    through the trunk, 6 neighbours of 4 centres, EGLA over 4 frames) and
    at the per-window ones (1 frame, 6 neighbours of 1 centre, EGLA over 6
    frames). No timing."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for h, w in EVAL_GEOMETRIES:
        for label, m, e in (("k=4", 4, 4), ("one window", 1, 6)):
            def args_of(kind, dtype, g, m=m, e=e):
                if kind in ("block", "blockq", "group", "head", "tail"):
                    return kc.trunk_args(kind, dtype, g, (m, h, w, 64), nbr=6)
                if kind in ("eg1", "eg2"):
                    return kc.egla_args(kind, dtype, g, (e, h, w, 64))
                return kc.align_embed_args(kind, dtype, g, (m, h, w), 6)
            check_kernel_table(card, MODEL_PATH_KERNELS,
                               [(f"{label} at {h}x{w}", False, args_of)],
                               seed=8, dtypes=(torch.bfloat16,))
            for kind, shape in (("token", (e * h, w, 64)),
                                ("column", (e, h, w, 64))):
                kernel, plain = WRAPPERS[kind]
                q, v = kc.attention_args(torch.bfloat16, g, shape)
                out, ref = kernel(q, v), plain(q, v)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = kc.TOLERANCE[torch.bfloat16]
                line = (f"kernel {kind} {label} at {h}x{w} {shape} bfloat16: "
                        f"max_abs_err {err:.3e} (max |plain| {scale:.3f}, "
                        f"rel {err / scale:.3e}, tolerance rel {tol:.1e})")
                print(line, flush=True)
                if not err <= tol * scale:
                    raise AssertionError(f"kernel disagrees with plain: "
                                         f"{line}")
            torch.cuda.empty_cache()


def check_inferencer(card: str) -> dict:
    """Phase 8(b): ``StreamingInferencer`` on 8 synthetic 272x480 frames
    (full width, bf16, the seeded weights) unfused, with the four flags and
    with path A: forward-only fps by the JAX protocol, each window's
    launches, the fused frames against the unfused ones (>= 40 dB, 30 with
    ``trunk_int8``) and each run against the engine's frames for the same
    flags and weights (>= 40 dB: the two compute the same windows).
    Returns the launches per window of the four-flag run, and the int8
    ``Block_``'s of path A's."""
    data = synthetic_sequence(t=EVAL_FRAMES, h=272, w=480, seed=0)
    frames, per_window = {}, {}
    for label, flags in (("unfused", {}), ("four flags", ALL_FLAGS),
                         ("path A", PATH_A)):
        model = seeded_model(ModelConfig(compute_dtype=torch.bfloat16,
                                         **flags))
        inf = StreamingInferencer(model)
        inf.run_sequence(data)   # warm-up: cuDNN/cuBLAS plans, allocator
        reset_launches()
        out, fps = inf.run_sequence(data, collect_timing=True)
        launches = launch_counts()
        engine, _ = BatchedStreamingEngine(model, k=4).run_sequence(data)
        against_engine = psnr(out, engine)
        print(f"inferencer (CVSR_V8 nf=64, 7 groups, bf16, 272x480 -> "
              f"1080x1920, {EVAL_FRAMES} frames, {label} {flags}): "
              f"{fps:.3f} fps forward-only by the JAX protocol ((T - 1) / "
              f"the forwards' time, frame 0 left out); against the engine's "
              f"frames PSNR {against_engine:.3f} dB (max diff "
              f"{np.abs(out.astype(np.int32) - engine).max()} LSB); "
              f"launches {launches} [{card}]", flush=True)
        want = {k: n * EVAL_FRAMES for k, n in window_launches(flags).items()}
        if launches != want:
            raise AssertionError(f"inferencer {label}: expected launches "
                                 f"{want}, got {launches}")
        if out.shape != (EVAL_FRAMES, 1080, 1920) or out.std() == 0:
            raise AssertionError(f"inferencer {label}: frames {out.shape}")
        if not against_engine >= 40.0:
            raise AssertionError(f"inferencer {label} is {against_engine:.2f}"
                                 " dB from the engine (limit 40 dB)")
        frames[label] = out
        per_window[label] = {k: n / EVAL_FRAMES for k, n in launches.items()}
        del model, inf
        torch.cuda.empty_cache()
    for label in ("four flags", "path A"):
        quality = psnr(frames[label], frames["unfused"])
        limit = 30.0 if label == "path A" else 40.0
        print(f"inferencer {label}: against the unfused frames PSNR "
              f"{quality:.3f} dB (limit {limit})", flush=True)
        if not quality >= limit:
            raise AssertionError(f"inferencer {label} is {quality:.2f} dB "
                                 f"from the unfused frames")
    return {**per_window["four flags"], "blockq": per_window["path A"]
            ["blockq"]}


def check_eval_tool(card: str) -> None:
    """Phase 8(c): ``eval_jctvc.evaluate_jctvc`` on a synthetic eval tree
    (3 frames each of 400x640 and 184x320) with the seeded weights (given
    as a reference-style float32 ``.pth``), unfused and with the four
    flags and ``trunk_int8`` (bf16): its JSON lines, the path-A frames
    >= 30 dB from the unfused ones, and path A's kernels launched."""
    with tempfile.TemporaryDirectory(prefix="cdfo_eval_") as tmp:
        eval_jctvc.write_synthetic_tree(tmp, EVAL_SEQUENCES, 3)
        ckpt = os.path.join(tmp, "seeded.pth")
        torch.save({k: v.float().cpu() for k, v in seeded_model(
            ModelConfig(), device="cpu").state_dict().items()}, ckpt)
        frames = {}
        for label, flags in (("unfused", {}), ("path A", PATH_A)):
            reset_launches()
            eval_jctvc.evaluate_jctvc(
                ModelConfig(compute_dtype=torch.bfloat16, **flags), tmp,
                "cuda", ckpt=ckpt, out=os.path.join(tmp, label),
                log=os.path.join(tmp, label + ".txt"),
                sequences=EVAL_SEQUENCES,
                echo=lambda line, label=label: print(
                    f"eval_jctvc {label}: {line} [{card}]", flush=True))
            launches = launch_counts()
            for seq in EVAL_SEQUENCES:
                d = os.path.join(tmp, label, "LD_QP37", seq)
                frames[label, seq] = np.stack([
                    data_io.read_gray(os.path.join(d, f))
                    for f in sorted(os.listdir(d))])
        missing = [k for k, n in window_launches(PATH_A).items()
                   if n and not launches[k]]
        if missing:
            raise AssertionError(f"eval_jctvc path A launched none of "
                                 f"{missing}: {launches}")
    for seq in EVAL_SEQUENCES:
        a, ref = frames["path A", seq], frames["unfused", seq]
        quality = psnr(a, ref)
        print(f"eval_jctvc {seq} {a.shape}: path A against unfused PSNR "
              f"{quality:.3f} dB (limit 30)", flush=True)
        if not quality >= 30.0:
            raise AssertionError(f"eval_jctvc {seq}: path A is "
                                 f"{quality:.2f} dB from unfused")


def check_sampled_engine(card: str) -> None:
    """Phase 8(d): ``BatchedStreamingEngine`` with the sampled mask on the
    card (full width, bf16, ``fused_trunk``, 8 frames of 272x480, two EGLA
    mask channels put on alike so that the noise decides between them):
    frames not constant, two seeds give other frames, one seed the same
    frames timed and untimed."""
    model = CVSRV8(ModelConfig(compute_dtype=torch.bfloat16,
                               mask_mode="sample", fused_trunk=True),
                   generator=torch.Generator().manual_seed(0))
    kc.excite_egla_mask(model, 3)
    kc.excite_egla_mask(model, 5)
    data = synthetic_sequence(t=EVAL_FRAMES, h=272, w=480, seed=0)

    def run(seed, timed=False):
        return BatchedStreamingEngine(
            model, k=4, generator=torch.Generator(device="cuda").manual_seed(
                seed)).run_sequence(data, collect_timing=timed)

    a, _ = run(1)
    timed, fps = run(1, timed=True)
    b, _ = run(2)
    moved = np.abs(a.astype(np.int32) - b)
    print(f"sampled-mask engine (fused_trunk, bf16, 272x480, k=4, "
          f"{EVAL_FRAMES} frames): {fps:.3f} fps timed; seeds 1 and 2 differ "
          f"in {np.count_nonzero(moved)} pixels (max {moved.max()} LSB, "
          f"PSNR {psnr(a, b):.3f} dB); seed 1 timed equals untimed "
          f"{np.array_equal(a, timed)} [{card}]", flush=True)
    if a.shape != (EVAL_FRAMES, 1080, 1920) or a.std() == 0:
        raise AssertionError("sampled-mask engine frames")
    if not np.array_equal(a, timed) or np.array_equal(a, b):
        raise AssertionError("sampled-mask engine: seeds do not decide the "
                             "frames")


def check_eval(card: str) -> dict:
    """Phase 8; returns the per-window launches of the inferencer's
    four-flag run (the int8 ``Block_``'s from path A's)."""
    check_eval_kernels(card)
    per_window = check_inferencer(card)
    check_eval_tool(card)
    check_sampled_engine(card)

    def log(line):
        print(f"int8_delta: {line} [{card}]", flush=True)
    out = int8_delta.run(ModelConfig(scn_groups=2), 300, "cuda", log=log)
    if not abs(out["int8_delta"]) <= int8_delta.BUDGET_DB:
        raise AssertionError(f"the int8 trunk is {out['int8_delta']:+.4f} dB "
                             f"from the plain one (budget "
                             f"{int8_delta.BUDGET_DB} dB)")

    def log(line):
        print(f"gumbel_variance: {line} [{card}]", flush=True)
    out = gumbel_variance.run(ModelConfig(scn_groups=2, mask_mode="sample"),
                              300, 4, "cuda", log=log)
    if len(set(out["samples"])) == 1:
        raise AssertionError("gumbel_variance: every seed gave one PSNR")
    return per_window


# -- phase 9: the model zoo --------------------------------------------------------

# the ablation whose small slice also runs the int8 trunk on the card
ZOO_INT8_SMALL = "woPd"
ZOO_FRAMES = 8


def zoo_launches(cfg: ModelConfig, calls: int, steps: int) -> dict:
    """Kernel launches of an engine run of ``cfg`` with ``calls``
    ``compensate_frames`` and ``steps`` ``align_reconstruct`` calls: the
    table of phase 5, less the kernels of the modules an ablation drops."""
    want = {k: 0 for k in launch_counts()}
    if cfg.use_la and cfg.use_ga and cfg.use_egla:
        if cfg.fused_egla:
            want.update(column=calls, eg1=calls, eg2=calls)
        else:
            want.update(token=calls, column=calls)
    if cfg.fused_embed:
        want.update({k: n * calls for k, n in EMBED_LAUNCHES.items()})
    if cfg.fused_trunk:
        want.update({k: n * steps for k, n in TRUNK_LAUNCHES.items()})
        if cfg.trunk_int8:
            want.update(block=0, blockq=TRUNK_LAUNCHES["block"] * steps)
    if cfg.fused_align:
        want.update({k: n * steps for k, n in ALIGN_LAUNCHES.items()})
    if cfg.block_warp:
        want["warp"] = steps
    return want


def check_zoo_small() -> None:
    """Phase 9(a): card (kernels) against CPU (plain versions) on the same
    weights, float32, TF32 off, phase 4's size: each CVSR_V8 ablation
    through the engine unfused and with every kernel flag it admits (woPd
    also with ``trunk_int8``), uint8 within 1 LSB; CVSR_V9 with
    ``fused_trunk`` and CVSR_V7 through the inferencer, within 1 LSB;
    SIDECVSR's forward with and without ``pre_l1`` within 1e-4 of the
    CPU's largest value."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = synthetic_sequence(t=9, h=16, w=24, seed=3)

    def compare(label, run, limit=1):
        out = {dev: run(dev) for dev in ("cpu", "cuda")}
        diff = np.abs(out["cuda"].astype(np.int32) - out["cpu"])
        print(f"zoo small ({label}, nf=64, 2 groups, 16x24, fp32): card vs "
              f"CPU max diff {diff.max()} LSB over {diff.size} pixels",
              flush=True)
        if diff.max() > limit or out["cuda"].std() == 0:
            raise AssertionError(f"zoo small {label}: card disagrees")

    for name, ablation in kc.ABLATIONS.items():
        settings = [{}, kc.admitted_flags(ablation)]
        if name == ZOO_INT8_SMALL:
            settings.append(dict(settings[1], trunk_int8=True))
        for flags in settings:
            cfg = ModelConfig(scn_groups=2, **ablation, **flags)
            compare(f"{name} engine k=4 {flags}", lambda dev, cfg=cfg:
                    BatchedStreamingEngine(kc.zoo_model(cfg, dev), k=4)
                    .run_sequence(data)[0])
    short = synthetic_sequence(t=5, h=16, w=24, seed=3)
    for name, flags in (("cvsr_v9", dict(fused_trunk=True)), ("cvsr_v7", {})):
        cfg = ModelConfig(name=name, scn_groups=2, **flags)
        compare(f"{name} inferencer {flags}", lambda dev, cfg=cfg:
                StreamingInferencer(kc.zoo_model(cfg, dev)).run_sequence(
                    short)[0])
    cfg = ModelConfig(name="sidecvsr", scn_groups=2)
    r = np.random.RandomState(4)
    x, pms, rms, ufs = (torch.from_numpy(r.rand(1, 7, 16, 24, 1)
                                         .astype(np.float32))
                        for _ in range(4))
    mvs = torch.from_numpy((r.randn(1, 7, 16, 24, 2) * 2).astype(np.float32))
    pre = torch.from_numpy(r.rand(1, 7, 16, 24, 64).astype(np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        model = kc.zoo_model(cfg, dev)
        with torch.no_grad():
            outs[dev] = [model(*(t.to(dev) for t in (x, mvs, pms, rms, ufs)),
                               pre_l1=p)[0].cpu()
                         for p in (None, pre.to(dev))]
    for label, a, b in zip(("no pre_l1", "pre_l1"), outs["cuda"], outs["cpu"]):
        err = (a - b).abs().max().item() / b.abs().max().item()
        print(f"zoo small (sidecvsr forward, {label}, nf=64, 2 groups, "
              f"16x24, fp32): card vs CPU rel err {err:.3e}", flush=True)
        if not err <= 1e-4:
            raise AssertionError(f"sidecvsr {label}: card disagrees")


def run_zoo_slice(card: str, name: str, flags: dict):
    """Phase 9(b) for one ablation and one setting of the flags: CVSR_V8
    nf 64, 7 groups, bf16, ``BatchedStreamingEngine(k=4)`` on 12 frames of
    272x480, timed; returns (frames, launches, fps, peak GiB)."""
    t, k = 12, 4
    cfg = ModelConfig(compute_dtype=torch.bfloat16, **kc.ABLATIONS[name],
                      **flags)
    eng = BatchedStreamingEngine(kc.zoo_model(cfg), k=k)
    data = synthetic_sequence(t=t, h=272, w=480, seed=0)
    eng.run_sequence(data)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frames, fps = eng.run_sequence(data, collect_timing=True)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(range(0, t, k))
    want = zoo_launches(cfg, 1 + steps, steps)
    print(f"zoo {name} (CVSR_V8 nf=64, 7 groups, bf16, 272x480 -> "
          f"1080x1920, k={k}, {t} frames, {flags}): {fps:.3f} fps by the "
          f"reference protocol, peak memory {peak:.2f} GiB; "
          f"compensate_frames calls {1 + steps}, align_reconstruct calls "
          f"{steps}, kernel launches {launches} [{card}]", flush=True)
    if frames.shape != (t, 1080, 1920) or frames.std() == 0:
        raise AssertionError(f"zoo {name}: frames {frames.shape}")
    if launches != want:
        raise AssertionError(f"zoo {name} {flags}: expected launches {want}, "
                             f"got {launches}")
    del eng
    torch.cuda.empty_cache()
    return frames, launches, fps, peak


def check_zoo_full(card: str) -> dict:
    """Phase 9(b): each ablation unfused and with every flag it admits plus
    ``trunk_int8``; the fused frames >= 30 dB from the unfused ones.
    Returns {ablation: the fused run's launches}."""
    out = {}
    for name, ablation in kc.ABLATIONS.items():
        plain = run_zoo_slice(card, name, {})[0]
        flags = dict(kc.admitted_flags(ablation), trunk_int8=True)
        frames, launches, _, _ = run_zoo_slice(card, name, flags)
        quality = psnr(frames, plain)
        print(f"zoo {name} {flags}: fused vs unfused uint8 frames PSNR "
              f"{quality:.3f} dB (limit 30 with trunk_int8)", flush=True)
        if not quality >= 30.0:
            raise AssertionError(f"zoo {name}: fused frames are "
                                 f"{quality:.2f} dB from the unfused ones")
        out[name] = launches
    return out


def variant_window_launches(cfg: ModelConfig) -> dict:
    """Launches of one per-window forward of CVSR_V9 / CVSR_V7: CVSR_V8's
    for the same flags, less EGLA's (their attention variants run no
    kernel)."""
    want = window_launches(dataclasses.asdict(cfg))
    want.update(token=0, column=0)
    return want


def check_zoo_variants(card: str) -> None:
    """Phase 9(c): CVSR_V9 (``fused_trunk`` + ``fused_embed``, then with
    ``trunk_int8``) and CVSR_V7 through ``StreamingInferencer`` on 8
    frames of 272x480 (nf 64, 7 groups, bf16): fps by the JAX protocol,
    peak memory, launches per window; the int8 V9 >= 30 dB from the exact
    one. SIDECVSR (4 groups) over 8 windows of 272x480 (the first full,
    then with ``pre_l1``): ms per window and peak memory."""
    data = synthetic_sequence(t=ZOO_FRAMES, h=272, w=480, seed=0)
    frames = {}
    for name, flags in (("cvsr_v9", dict(fused_trunk=True,
                                         fused_embed=True)),
                        ("cvsr_v9", dict(fused_trunk=True, fused_embed=True,
                                         trunk_int8=True)),
                        ("cvsr_v7", {})):
        cfg = ModelConfig(name=name, compute_dtype=torch.bfloat16, **flags)
        inf = StreamingInferencer(kc.zoo_model(cfg))
        inf.run_sequence(data)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out, fps = inf.run_sequence(data, collect_timing=True)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_window = {k: n / ZOO_FRAMES for k, n in launches.items() if n}
        print(f"zoo {name} inferencer (nf=64, {cfg.scn_groups} groups, "
              f"bf16, 272x480 -> 1080x1920, {ZOO_FRAMES} frames, {flags}): "
              f"{fps:.3f} fps forward-only by the JAX protocol, "
              f"{1e3 / fps:.1f} ms per window, peak memory {peak:.2f} GiB, "
              f"launches per window {per_window} [{card}]", flush=True)
        want = {k: n * ZOO_FRAMES
                for k, n in variant_window_launches(cfg).items()}
        if launches != want:
            raise AssertionError(f"zoo {name} {flags}: expected launches "
                                 f"{want}, got {launches}")
        if out.shape != (ZOO_FRAMES, 1080, 1920) or out.std() == 0:
            raise AssertionError(f"zoo {name}: frames {out.shape}")
        frames[(name, cfg.trunk_int8)] = out
        del inf
        torch.cuda.empty_cache()
    quality = psnr(frames[("cvsr_v9", True)], frames[("cvsr_v9", False)])
    print(f"zoo cvsr_v9: int8 trunk vs exact trunk PSNR {quality:.3f} dB "
          "(limit 30)", flush=True)
    if not quality >= 30.0:
        raise AssertionError("zoo cvsr_v9: the int8 trunk is "
                             f"{quality:.2f} dB from the exact one")
    cfg = ModelConfig(name="sidecvsr", compute_dtype=torch.bfloat16)
    model = kc.zoo_model(cfg)
    r = np.random.RandomState(0)
    x, pms, rms, ufs = (torch.from_numpy(r.rand(1, 7, 272, 480, 1).astype(
        np.float32)).cuda() for _ in range(4))
    mvs = torch.from_numpy((r.randn(1, 7, 272, 480, 2) * 4).astype(
        np.float32)).cuda()
    times = []
    with torch.inference_mode():
        for rep in range(2):   # the first pass warms up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            l1, times = None, []
            for _ in range(ZOO_FRAMES):
                t0 = time.perf_counter()
                sr, l1 = model(x, mvs, pms, rms, ufs, pre_l1=l1)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    later = float(np.mean(times[1:]))
    print(f"zoo sidecvsr forward (nf=64, 4 groups, bf16, 272x480 -> "
          f"1080x1920, {ZOO_FRAMES} windows): first window (7 frames "
          f"embedded) {1e3 * times[0]:.1f} ms, then {1e3 * later:.1f} ms per "
          f"window with pre_l1 ({1 / later:.3f} windows/s), peak memory "
          f"{peak:.2f} GiB, kernel launches {sum(launches.values())} "
          f"[{card}]", flush=True)
    if any(launches.values()):   # its modules run no kernel of the port
        raise AssertionError(f"zoo sidecvsr: launches {launches}")
    if sr.shape != (1, 1088, 1920, 1) or not torch.isfinite(sr).all():
        raise AssertionError(f"zoo sidecvsr: output {tuple(sr.shape)}")
    del model
    torch.cuda.empty_cache()


def scan_train_run(scan: bool, batch: dict, u: torch.Tensor):
    """Two LD-preset train steps (nf 64, 7 groups, the sampled mask, bf16
    with float32 masters) from the seeded weights: (losses, parameters
    after, peak GiB)."""
    cfg = ModelConfig(mask_mode="sample", scan_trunk=scan,
                      compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = CVSRV8(cfg, torch.Generator().manual_seed(0))
    state = TrainState(model, TrainConfig())
    losses = [train_step(state, batch, gumbel_u=u).item() for _ in range(2)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = {n: p.detach().float().cpu()
              for n, p in model.state_dict().items()}
    del state, model
    return losses, params, peak


def check_scan_trunk(card: str) -> None:
    """Phase 9(d): two LD-preset train steps (batch 20, 7 frames of 64x64)
    unrolled and with ``scan_trunk``, on the same weights, batch and gumbel
    draw, with PyTorch's deterministic algorithms (the warp's and the
    resizes' backward scatter-adds otherwise move the weights whose
    gradients are at the rounding's size): the losses within 1e-4
    relative, the parameters after the second step within 1e-3 relative
    L2; both runs' peak memory."""
    r = np.random.RandomState(3)
    b, n, h, w = 20, 7, 64, 64
    lrs, pms, rms, ufs = (r.rand(b, n, h, w, 1).astype(np.float32)
                          for _ in range(4))
    mvs = (r.randn(b, n, h, w, 2) * 0.05).astype(np.float32)
    batch = {"lrs": lrs, "mvs0": mvs, "mvs1": np.zeros_like(mvs), "pms": pms,
             "rms": rms, "ufs": ufs,
             "hr": r.rand(b, 4 * h, 4 * w, 1).astype(np.float32)}
    u = torch.rand((b * (n - 1), h, w, 64),
                   generator=torch.Generator().manual_seed(5)).clamp_min(
        torch.finfo(torch.float32).tiny).cuda()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {scan: scan_train_run(scan, batch, u) for scan in (False, True)}
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
    (l0, p0, m0), (l1, p1, m1) = runs[False], runs[True]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
    param_err = max((rel_l2(p1[k], p), k) for k, p in p0.items())
    print(f"scan trunk (LD preset: CVSR_V8 nf=64, 7 groups, batch 20 of 7 "
          f"64x64 frames, sampled mask, bf16 + fp32 masters, 2 steps, "
          f"deterministic algorithms): losses unrolled {l0} / scan {l1} "
          f"(rel {loss_err:.3e}); worst parameter after 2 steps rel L2 "
          f"{param_err[0]:.3e} ({param_err[1]}); peak memory unrolled "
          f"{m0:.2f} GiB, scan {m1:.2f} GiB [{card}]", flush=True)
    if not (loss_err <= 1e-4 and param_err[0] <= 1e-3):
        raise AssertionError("the scan trunk's training disagrees with the "
                             "unrolled trunk's")


def check_zoo(card: str) -> dict:
    """Phase 9; returns each ablation's fused-run launches."""
    check_zoo_small()
    launches = check_zoo_full(card)
    check_zoo_variants(card)
    check_scan_trunk(card)
    return launches


# -- phase 10: the multi-card paths ---------------------------------------------

PARALLEL_T, PARALLEL_KPD = 12, 4


@torch.inference_mode()
def gather_cost(eng, data) -> tuple[int, float]:
    """The bytes of one step's ``all_gather`` (the three compensated
    features of the k new frames) and its ms (CUDA events, median of 15),
    on the first staged step's features."""
    _, steps = eng.stage_sequence(data)
    feats = eng._compensate(*steps[0][0][:4])
    nbytes = sum(f.numel() * f.element_size() for f in eng._gather(feats))
    return nbytes, median_ms(lambda: eng._gather(feats))


def check_sharded_engine(card: str):
    """Phase 10(a): path AB at full width through ``ShardedServingEngine``
    over a process group of one card (NCCL) and through the plain engine,
    timed in turns (plain, sharded, sharded, plain), each run's launches
    against path AB's table; the frames equal bit for bit."""
    cfg = ModelConfig(compute_dtype=torch.bfloat16, **PATH_AB)
    model = seeded_model(cfg)
    data = synthetic_sequence(t=PARALLEL_T, h=272, w=480, seed=0)
    engines = {"plain": BatchedStreamingEngine(model, k=PARALLEL_KPD),
               "sharded": ShardedServingEngine(model,
                                               k_per_device=PARALLEL_KPD)}
    for eng in engines.values():
        eng.run_sequence(data)   # warm-up
    steps = len(range(0, PARALLEL_T, PARALLEL_KPD))
    want = path_launches(PATH_AB, 1 + steps, steps)
    runs = collections.defaultdict(list)
    for name in ("plain", "sharded", "sharded", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        frames, fps = engines[name].run_sequence(data, collect_timing=True)
        launches = path_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != want:
            raise AssertionError(f"{name} engine: expected launches {want}, "
                                 f"got {launches}")
        runs[name].append((frames, fps, peak))
    plain = runs["plain"][0][0]
    same = all(np.array_equal(f, plain) for r in runs.values()
               for f, *_ in r)
    # the plain engine's own frames at twice the k: on the card a step's
    # batch size can change its library convolutions' rounding (phase 10(c))
    wide = BatchedStreamingEngine(model, k=2 * PARALLEL_KPD)
    wide.run_sequence(data)
    wide_frames, _ = wide.run_sequence(data, collect_timing=True)
    del wide
    nbytes, ms = gather_cost(engines["sharded"], data)
    barrier = []
    for _ in range(15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.barrier()
        barrier.append(1e3 * (time.perf_counter() - t0))
    fps = {n: [round(r[1], 3) for r in v] for n, v in runs.items()}
    peaks = {n: round(max(r[2] for r in v), 2) for n, v in runs.items()}
    ratio = np.mean(fps["sharded"]) / np.mean(fps["plain"])
    print(f"phase 10(a) sharded engine over 1 card (NCCL, k_per_device="
          f"{PARALLEL_KPD}), path AB, CVSR_V8 nf=64, 7 groups, bf16, "
          f"{PARALLEL_T} frames of 272x480: fps plain {fps['plain']} / "
          f"sharded {fps['sharded']} (in turns; sharded / plain "
          f"{ratio:.4f}); peak memory plain {peaks['plain']:.2f} / sharded "
          f"{peaks['sharded']:.2f} GiB; all_gather {nbytes} bytes a step, "
          f"{ms:.4f} ms (with its byte packing); barrier "
          f"{np.median(barrier):.4f} ms (host clock, median of 15); the plain "
          f"engine at k={2 * PARALLEL_KPD} against k={PARALLEL_KPD}: PSNR "
          f"{psnr(wide_frames, plain):.3f} dB, max diff "
          f"{np.abs(wide_frames.astype(np.int32) - plain).max()} LSB; frames equal to the plain engine's: {same}; "
          f"launches per run {want} [{card}]", flush=True)
    if not same or plain.shape != (PARALLEL_T, 1080, 1920):
        raise AssertionError("the sharded engine's frames differ from the "
                             "plain engine's")
    del engines, model
    torch.cuda.empty_cache()


def dp_train_run(root: str, ckpt: str) -> tuple:
    """Two LD-preset steps through ``train_loop`` (fused trunk, bf16 with
    float32 masters, the sampled mask), data-parallel when a process group
    exists: (losses, model state, masters, the second step's s)."""
    model_cfg = ModelConfig(mask_mode="sample", fused_trunk=True,
                            compute_dtype=torch.bfloat16)
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    losses, times = [], []

    def on_step(state, loss):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        losses.append(loss.item())

    state = train_loop(
        model_cfg, DataConfig(coding_cfg="LD", qp=37, frames_per_seq=10),
        TrainConfig(ckpt_dir=ckpt, val_interval=1), root, num_epochs=1,
        steps_per_epoch=2, device="cuda", on_step=on_step,
        on_start=lambda s: times.append(time.perf_counter()),
        host_id=rank, num_hosts=world)
    model = {k: v.detach().clone() for k, v in
             state.model.state_dict().items()}
    masters = [m.detach().clone() for m in state.masters]
    return losses, model, masters, times[2] - times[1], state.data_parallel


def check_parallel(card: str) -> None:
    """Phase 10: (b)'s non-distributed run first, then a process group of
    one card (NCCL) for (a) and (b)'s distributed run, destroyed after;
    then (c) over every card, when there are two or more."""
    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="cdfo_parallel_") as tmp:
        root = os.path.join(tmp, "cvcp")
        data_io.make_synthetic_cvcp_tree(root, num_seqs=2, frames=10, h=64,
                                         w=96)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            single = dp_train_run(root, os.path.join(tmp, "single"))
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = deterministic
        initialize_distributed("cuda")
        try:
            check_sharded_engine(card)
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                spread = dp_train_run(root, os.path.join(tmp, "dp"))
            finally:
                torch.use_deterministic_algorithms(False)
                torch.backends.cudnn.deterministic = deterministic
        finally:
            dist.destroy_process_group()
    same = (single[0] == spread[0]
            and all(torch.equal(v, spread[1][k]) for k, v in single[1].items())
            and all(map(torch.equal, single[2], spread[2])))
    print(f"phase 10(b) data-parallel trainer over 1 card (NCCL), LD preset "
          f"(CVSR_V8 nf=64, 7 groups, batch 20 of 7 64x64 crops, sampled "
          f"mask, fused_trunk, bf16 + fp32 masters), 2 steps through "
          f"train_loop, deterministic algorithms: losses {spread[0]} "
          f"against the non-distributed trainer's {single[0]}; parameters "
          f"and masters equal: {same}; data-parallel {spread[4]} / "
          f"{single[4]}; second step {spread[3]:.4f} / {single[3]:.4f} s "
          f"[{card}]", flush=True)
    if not same or not spread[4] or single[4]:
        raise AssertionError("the data-parallel trainer at one rank differs "
                             "from the non-distributed trainer")
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"phase 10(c) did not run: {cards} card on this machine; the "
              f"sharded engine over several cards needs two or more",
              flush=True)
        return
    check_multi_card(card, cards)


def parallel_rank(rank: int, world: int, port: int, out: str) -> None:
    """Phase 10(c)'s rank: path AB through ``ShardedServingEngine`` over
    ``world`` cards on ``PARALLEL_T * world`` frames; rank 0 saves the
    frames and the fps of its timed run (after a warm-up)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    initialize_distributed("cuda")
    try:
        model = seeded_model(ModelConfig(compute_dtype=torch.bfloat16,
                                         **PATH_AB))
        eng = ShardedServingEngine(model, k_per_device=PARALLEL_KPD)
        data = synthetic_sequence(t=PARALLEL_T * world, h=272, w=480, seed=0)
        eng.run_sequence(data)
        frames, fps = eng.run_sequence(data, collect_timing=True)
        if rank == 0:
            np.save(os.path.join(out, "frames.npy"), frames)
            with open(os.path.join(out, "fps.json"), "w") as f:
                json.dump(fps, f)
    finally:
        dist.destroy_process_group()


def check_multi_card(card: str, cards: int) -> None:
    """Phase 10(c): the sharded engine over 2 .. ``cards`` cards (one
    spawned process each), ``PARALLEL_T`` frames a card, against the plain
    engine on one card over the same frames, fps by card count. Each rank's
    steps compensate and reconstruct 4 frames a call, as the plain engine's
    do, but the bootstrap compensates k + 6 frames in one call, and the
    library convolutions of the plain modules may choose another algorithm
    at another batch size: the frames are held to rounding (>= 50 dB, as
    phase 5 holds the block warp), and whether they are equal bit for bit
    is printed."""
    import socket

    import torch.multiprocessing as mp
    model = seeded_model(ModelConfig(compute_dtype=torch.bfloat16, **PATH_AB))
    for n in range(2, cards + 1):
        data = synthetic_sequence(t=PARALLEL_T * n, h=272, w=480, seed=0)
        eng = BatchedStreamingEngine(model, k=PARALLEL_KPD)
        eng.run_sequence(data)
        plain, plain_fps = eng.run_sequence(data, collect_timing=True)
        del eng
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        with tempfile.TemporaryDirectory(prefix="cdfo_cards_") as out:
            mp.start_processes(parallel_rank, args=(n, port, out), nprocs=n,
                               start_method="spawn", join=True)
            frames = np.load(os.path.join(out, "frames.npy"))
            with open(os.path.join(out, "fps.json")) as f:
                fps = json.load(f)
        quality = psnr(frames, plain)
        diff = np.abs(frames.astype(np.int32) - plain).max()
        print(f"phase 10(c) sharded engine over {n} cards (NCCL, "
              f"k_per_device={PARALLEL_KPD}, k={PARALLEL_KPD * n}), path AB, "
              f"{PARALLEL_T * n} frames of 272x480: fps by card count 1 "
              f"(plain engine, k={PARALLEL_KPD}) {plain_fps:.3f}, {n} "
              f"{fps:.3f} ({fps / plain_fps:.3f}x); against the plain "
              f"engine's frames PSNR {quality:.3f} dB, max diff {diff} LSB, "
              f"equal bit for bit: {diff == 0} [{card}]", flush=True)
        if frames.shape != plain.shape or not quality >= 50.0:
            raise AssertionError("the multi-card frames differ from the "
                                 f"plain engine's by more than rounding: "
                                 f"{quality:.2f} dB")


def ptxas_fault(line: str) -> bool:
    """A ptxas line that reports a spill (a non-zero spill store or load)
    or a C75xx warning (``wgmma`` serialized, or a wait or arrive
    injected)."""
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
    return "C75" in line or bool(spills and (int(spills[1]) or
                                            int(spills[2])))


def entry_name(line: str) -> str:
    """The kernel a ptxas "Compiling entry function '<mangled>'" line
    names: the last identifier of its (nested) name, with its template
    argument where it is float, bf16 or a bool, else the mangled name."""
    mangled = line.split("'")[1] if "'" in line else line
    nested = mangled.startswith("_ZN")
    i = 3 if nested else 2
    name, rest = None, ""
    while mangled.startswith("_Z") and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        rest = mangled[i:]
        if not nested:
            break
    if not name:
        return f"entry {mangled}"
    args = {"IfE": "<float>", "I13__nv_bfloat16E": "<bf16>", "ILb0E": "<false>",
            "ILb1E": "<true>"}
    if rest.startswith("ILi") and "E" in rest[3:]:   # an int argument
        return f"entry {name}<{rest[3:rest.index('E', 3)]}>"
    return "entry " + name + next(
        (v for k, v in args.items() if rest.startswith(k)), "")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs the port on a GPU and has no CPU mode")
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    serialized, probe_faults = [], []
    try:
        cuda_build.build(*LIBRARIES)
    finally:
        for name in LIBRARIES:
            log = cuda_build.library_path(name).with_suffix(".log")
            if not log.exists():
                continue
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    print(f"  {name}: {entry_name(line)}", flush=True)
                if any(k in line for k in ("registers", "spill", "rror", "C75")):
                    line = line.replace("ptxas info    :", "ptxas:").strip()
                    print(f"  {name}: {line}", flush=True)
                if "wgmma.mma_async instructions are serialized" in line:
                    serialized.append(name)
                if name in PROBE_LIBRARIES and ptxas_fault(line):
                    probe_faults.append(f"{name}: {line.strip()}")
    print(f"built {len(LIBRARIES)} libraries in parallel in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if serialized:
        raise AssertionError(f"ptxas serializes the wgmma products of "
                             f"{sorted(set(serialized))}")
    if probe_faults:
        raise AssertionError(f"ptxas spills or warns in the probes: "
                             f"{probe_faults}")
    if sys.argv[1:2] == ["--profile"]:
        profile_main_path(card, sys.argv[2:])
        return
    if sys.argv[1:2] == ["--phases"]:
        run_phase_clocks(card, sys.argv[2:] or PHASE_KINDS)
        return
    if sys.argv[1:2] == ["--train"]:
        check_training(card)
        return
    if sys.argv[1:2] == ["--eval"]:
        check_eval(card)
        return
    if sys.argv[1:2] == ["--zoo"]:
        check_zoo(card)
        return
    if sys.argv[1:2] == ["--parallel"]:
        check_parallel(card)
        return

    fields = check_kernels(card)
    fields.update(check_trunk_kernels(card))
    fields.update(check_align_embed_kernels(card))
    fields.update(check_egla_kernels(card))
    fields.update(check_int8_kernel(card))
    fields["block"]["ms"] = fields.pop("block_packed_ms")
    fields.update(check_warp_kernel(card))
    fields.update(check_body_kernel(card))
    fields.update(check_probe_kernels(card))
    three = dict(fused_trunk=True, fused_embed=True, fused_align=True)
    settings = (dict(fused_trunk=True), three, ALL_FLAGS, PATH_A, PATH_B,
                PATH_AB)
    check_small_slice()
    for flags in settings[:-1]:
        check_small_slice(**flags)
    plain_frames, _ = run_full_slice(card)
    launches = {}
    for flags in settings:
        frames, counted = run_full_slice(card, **flags)
        quality = psnr(frames, plain_frames)
        print(f"full slice {flags}: fused vs unfused uint8 frames PSNR "
              f"{quality:.3f} dB (max diff "
              f"{np.abs(frames.astype(np.int32) - plain_frames).max()} LSB)",
              flush=True)
        # the int8 trunk is approximate: its floor only catches a broken run
        limit = 30.0 if flags.get("trunk_int8") else 40.0
        if not quality >= limit:
            raise AssertionError(f"fused frames are {quality:.2f} dB from "
                                 f"the unfused ones (limit {limit} dB)")
        if flags == ALL_FLAGS:
            exact_frames = frames
            launches.update(counted)
        elif flags in (PATH_A, PATH_B, PATH_AB):
            against = psnr(frames, exact_frames)
            print(f"full slice {flags}: against the exact four-flag frames "
                  f"PSNR {against:.3f} dB (max diff "
                  f"{np.abs(frames.astype(np.int32) - exact_frames).max()} "
                  f"LSB)", flush=True)
            if flags == PATH_B and not against >= 50.0:
                raise AssertionError("the block warp changed the frames by "
                                     f"more than rounding: {against:.2f} dB")
            # each new kernel's launches from the run of its own path
            if flags == PATH_A:
                launches["blockq"] = counted["blockq"]
            elif flags == PATH_B:
                launches["warp"] = counted["warp"]
    launches.update(run_tools(card))
    redesign_order(card, fields, launches)
    train_launches = check_training(card)
    window_launches_per_frame = check_eval(card)
    zoo_launches_per_run = check_zoo(card)
    check_parallel(card)

    # launches: the four-flag run's; the int8 Block_'s from path A's run and
    # the warp's from path B's
    kernels = [
        {"name": f"fused_attention.{kind}_self_attention", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES,
         "launches": launches[kind], **fields[kind]}
        for kind in ("token", "column")]
    kernels += [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[kind], **fields[kind]}
        for kind, (name, _, _, source, replaces) in {
            **ALL_KERNELS, **TOOL_KERNELS}.items()]
    # the trained kernels' launches per LD training step (phase 7)
    for entry, kind in zip(kernels, ("token", "column", *ALL_KERNELS,
                                     *TOOL_KERNELS)):
        if kind in TRAIN_LAUNCHES:
            entry["train_launches_per_step"] = train_launches[kind]
        # the inferencer's launches per frame (phase 8(b)), where it runs
        # the kernel
        if window_launches_per_frame.get(kind):
            entry["window_launches_per_frame"] = window_launches_per_frame[kind]
        # each ablation's launches in its full-width run with every flag it
        # admits and trunk_int8 (phase 9(b))
        zoo = {name: counts[kind] for name, counts in
               zoo_launches_per_run.items() if counts.get(kind)}
        if zoo:
            entry["zoo_launches_per_run"] = zoo
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
