"""The configurations of the PyTorch port (mirror ``cdfo_tpu.config``):
``ModelConfig``, and for training ``DataConfig``, ``TrainConfig`` and the
reference recipes ``ld_qp37`` / ``ra_qp37``.

The port runs these slices of the JAX package: CVSR_V8 with the
noise-free ("expected") or the gumbel-sampled ("sample") EGLA mask, in
float32 or bfloat16, with ``fused_trunk`` (the
trunk, the upsample head and the alignment tail as hand-written kernels on
a GPU), ``fused_embed`` (the GCPI rounds' MDTA), ``fused_align`` (the dual
MSA; it needs ``fused_trunk``, as the JAX model reaches it only there) and
``fused_egla`` (EGLA; it needs the noise-free mask, as the JAX model takes
it only there) each off or on; ``trunk_int8`` (the int8 trunk kernel; it needs
``fused_trunk``, under which alone the JAX model reads it) and
``block_warp`` (the block-gather neighbour warp) likewise. The four fused
flags with ``trunk_int8`` are the JAX headline configuration; without it,
its exact-trunk side-by-side. ``scan_trunk`` is off. A setting outside
those slices raises naming the work that would add it, so nothing silently
ignores a field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_LATER = {
    "scan_trunk": "the scan trunk (ROADMAP Queue 1, item 1.6, model zoo)",
}
_MASK_MODES = ("expected", "sample")
_ABLATIONS = ("use_pab", "use_la", "use_ga", "use_mv", "use_pd", "use_egla")
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """CVSR_V8 hyper-parameters; field names and meanings follow
    ``cdfo_tpu.config.ModelConfig``.

    ``mask_mode`` defaults to ``"expected"`` here (the JAX default is
    ``"sample"``): the port's entry points are inference and evaluation,
    and the JAX eval tools pick the deterministic mask too
    (`tools/test_sr.py:28`, `tools/eval_jctvc.py:68`). The trainer asks
    for ``"sample"``, as ``cdfo_tpu``'s does by its default.
    """

    name: str = "cvsr_v8"
    nf: int = 64
    nframes: int = 7
    mdta_heads: int = 8
    align_heads: int = 4
    scn_groups: int = 7
    scale: int = 4
    mask_mode: str = "expected"
    use_pab: bool = True
    use_la: bool = True
    use_ga: bool = True
    use_mv: bool = True
    use_pd: bool = True
    use_egla: bool = True
    fused_trunk: bool = False
    scan_trunk: bool = False
    trunk_int8: bool = False
    fused_embed: bool = False
    fused_align: bool = False
    fused_egla: bool = False
    block_warp: bool = False
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.name != "cvsr_v8":
            raise NotImplementedError(
                f"model {self.name!r}: only cvsr_v8 is ported; the other "
                "models wait for the model zoo (ROADMAP Queue 1, item 1.6)")
        if self.mask_mode not in _MASK_MODES:
            raise ValueError(f"mask_mode={self.mask_mode!r}: one of "
                             f"{_MASK_MODES}")
        if self.fused_egla and self.mask_mode == "sample":
            raise ValueError(
                "fused_egla=True needs mask_mode='expected': the fused EGLA "
                "composes a per-(frame, channel) mask into its q projection, "
                "and cdfo_tpu ignores the flag under the sampled mask")
        for f in _ABLATIONS:
            if not getattr(self, f):
                raise NotImplementedError(
                    f"{f}=False: the CVSR_V8 ablations wait for the model "
                    "zoo (ROADMAP Queue 1, item 1.6)")
        for f, work in _LATER.items():
            if getattr(self, f):
                raise NotImplementedError(f"{f}=True: waits for {work}")
        if self.fused_align and not self.fused_trunk:
            raise ValueError(
                "fused_align=True needs fused_trunk=True: the fused dual MSA "
                "feeds the fused alignment tail (cdfo_tpu reaches it only "
                "under fused_trunk and would ignore the flag otherwise)")
        if self.trunk_int8 and not self.fused_trunk:
            raise ValueError(
                "trunk_int8=True needs fused_trunk=True: the int8 Block_ is "
                "a kernel of the fused trunk (cdfo_tpu reads the flag only "
                "under fused_trunk and would ignore it otherwise)")
        if self.compute_dtype not in _DTYPES:
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype}: the port runs "
                "float32 and bfloat16 only")

    @property
    def center(self) -> int:
        return self.nframes // 2


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """CVCP-layout dataset config (``cdfo_tpu.config.DataConfig``; the
    reference's ``opt/data_LD_bi.py:10-135``). The JAX config's path and
    size fields, which nothing there reads, are left out."""

    coding_cfg: str = "LD"       # 'LD' | 'RA'
    qp: int = 37
    crop_size: int = 64
    nframes: int = 7
    frames_per_seq: int = 32
    # LD training feeds all-zero L1 flows to the aligner, as the
    # reference's Augment does (`opt/data_LD_bi.py:473-489`)
    zero_mvl1_in_train: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference recipe (``cdfo_tpu.config.TrainConfig``;
    `train_LD_37.py:37-47,323-325,377,419`). The compute dtype is the
    model's (``ModelConfig.compute_dtype``; a bfloat16 model trains with
    float32 master weights, ``train/state.py``). The JAX config's mesh
    fields (data parallelism, ROADMAP Queue 1, item 1.8) and its unread
    ``warm_start_epoch`` and ``bf16_compute`` are left out."""

    lr: float = 1e-4
    weight_decay: float = 1e-5
    batch_size: int = 20         # 24 for RA (`train_RA_37.py:153`)
    epochs: int = 30000
    val_interval: int = 200      # 400 for RA
    milestones: Tuple[int, ...] = (2000,)
    gamma: float = 0.5
    seed: int = 4
    ckpt_dir: str = "training_results"


def ld_qp37() -> tuple[ModelConfig, DataConfig, TrainConfig]:
    """The LD QP37 recipe, with the sampled EGLA mask ``cdfo_tpu`` trains
    with."""
    return (ModelConfig(mask_mode="sample"), DataConfig(coding_cfg="LD", qp=37),
            TrainConfig())


def ra_qp37() -> tuple[ModelConfig, DataConfig, TrainConfig]:
    return (
        ModelConfig(mask_mode="sample"),
        DataConfig(coding_cfg="RA", qp=37, zero_mvl1_in_train=False),
        TrainConfig(batch_size=24, val_interval=400),
    )
