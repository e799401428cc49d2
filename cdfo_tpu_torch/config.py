"""The configurations of the PyTorch port (mirror ``cdfo_tpu.config``):
``ModelConfig``, and for training ``DataConfig``, ``TrainConfig`` and the
reference recipes ``ld_qp37`` / ``ra_qp37``.

The port runs every model of ``cdfo_tpu``'s ``MODEL_REGISTRY``
(``models.build_model``): CVSR_V8 and its ablations (``use_pab``,
``use_la``, ``use_ga``, ``use_mv``, ``use_pd``, ``use_egla``; a registry
name ``cvsr_v8_wo*`` switches its own flag off), CVSR_V9, CVSR_V7 and
SIDECVSR, with the noise-free ("expected") or the gumbel-sampled
("sample") EGLA / RDAB mask, in float32 or bfloat16. On the CVSR_V8 family
the kernel flags ``fused_trunk`` (the trunk, the upsample head and the
alignment tail as hand-written kernels on a GPU), ``fused_embed`` (the GCPI
rounds' MDTA), ``fused_align`` (the dual MSA; it needs ``fused_trunk``, as
the JAX model reaches it only there) and ``fused_egla`` (EGLA; it needs
the noise-free mask, as the JAX model takes it only there), ``trunk_int8``
(the int8 trunk kernel; it needs ``fused_trunk``, under which alone the
JAX model reads it) and ``block_warp`` (the block-gather neighbour warp)
are each off or on, where the model has the module they replace; CVSR_V9
takes ``fused_trunk``, ``fused_embed`` and ``trunk_int8``; CVSR_V7 and
SIDECVSR take none. ``scan_trunk`` runs the trunk's groups under
``torch.utils.checkpoint`` (not with ``fused_trunk``). A setting that
``cdfo_tpu`` would ignore raises ``ValueError`` naming why, so nothing
silently ignores a field. ``mask_mode`` is read by the models that draw a
mask (CVSR_V8 with EGLA, CVSR_V7's RDAB) and, as in ``cdfo_tpu``, by no
other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_MASK_MODES = ("expected", "sample")
_ABLATIONS = ("use_pab", "use_la", "use_ga", "use_mv", "use_pd", "use_egla")
# registry names of the CVSR_V8 family and the flag each switches off
V8_NAMES = {"cvsr_v8": None, "cvsr_v8_wopab": "use_pab",
            "cvsr_v8_wola": "use_la", "cvsr_v8_woga": "use_ga",
            "cvsr_v8_womv": "use_mv", "cvsr_v8_wopd": "use_pd"}
MODEL_NAMES = (*V8_NAMES, "cvsr_v7", "cvsr_v9", "sidecvsr")
_KERNEL_FLAGS = ("fused_trunk", "fused_embed", "fused_align", "fused_egla",
                 "trunk_int8", "block_warp")
# the kernel flags each non-V8 model reads (cdfo_tpu/models/cvsr_variants.py:
# V9 is CVSR_V8 with EGLA1 in the RDAB slot, run per window)
_VARIANT_FLAGS = {"cvsr_v9": ("fused_trunk", "fused_embed", "trunk_int8"),
                  "cvsr_v7": (), "sidecvsr": ()}
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyper-parameters; field names and meanings follow
    ``cdfo_tpu.config.ModelConfig``.

    ``mask_mode`` defaults to ``"expected"`` here (the JAX default is
    ``"sample"``): the port's entry points are inference and evaluation,
    and the JAX eval tools pick the deterministic mask too
    (`tools/test_sr.py:28`, `tools/eval_jctvc.py:68`). The trainer asks
    for ``"sample"``, as ``cdfo_tpu``'s does by its default.
    ``scn_groups`` left at None is 4 for ``sidecvsr`` and 7 for the other
    models, the depths ``cdfo_tpu``'s registry builds them at.
    """

    name: str = "cvsr_v8"
    nf: int = 64
    nframes: int = 7
    mdta_heads: int = 8
    align_heads: int = 4
    scn_groups: Optional[int] = None
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
        if self.name not in MODEL_NAMES:
            raise ValueError(f"model {self.name!r}: one of {MODEL_NAMES}")
        if self.scn_groups is None:
            object.__setattr__(self, "scn_groups",
                               4 if self.name == "sidecvsr" else 7)
        if V8_NAMES.get(self.name):
            object.__setattr__(self, V8_NAMES[self.name], False)
        if self.mask_mode not in _MASK_MODES:
            raise ValueError(f"mask_mode={self.mask_mode!r}: one of "
                             f"{_MASK_MODES}")
        if self.compute_dtype not in _DTYPES:
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype}: the port runs "
                "float32 and bfloat16 only")
        if self.scan_trunk and self.fused_trunk:
            raise ValueError(
                "scan_trunk=True with fused_trunk=True: cdfo_tpu ignores the "
                "scan trunk under the fused trunk (each Block_ is one "
                "kernel); ask for one of the two")
        if self.trunk_int8 and not self.fused_trunk:
            raise ValueError(
                "trunk_int8=True needs fused_trunk=True: the int8 Block_ is "
                "a kernel of the fused trunk (cdfo_tpu reads the flag only "
                "under fused_trunk and would ignore it otherwise)")
        if self.name in _VARIANT_FLAGS:
            self._check_variant()
        else:
            self._check_v8()

    def _check_variant(self):
        off = [f for f in _ABLATIONS if not getattr(self, f)]
        if off:
            raise ValueError(f"{off} on {self.name}: the ablation flags "
                             "belong to the CVSR_V8 family")
        unread = [f for f in _KERNEL_FLAGS if getattr(self, f)
                  and f not in _VARIANT_FLAGS[self.name]]
        if unread:
            raise ValueError(
                f"{unread} on {self.name}: cdfo_tpu's {self.name} has no "
                "module these flags replace (it reads only "
                f"{list(_VARIANT_FLAGS[self.name])})")

    def _check_v8(self):
        if self.fused_embed and not self.use_pab:
            raise ValueError(
                "fused_embed=True with use_pab=False: the fused GCPI rounds "
                "need the partition branch, and cdfo_tpu ignores the flag "
                "for woPAB")
        no_egla = [f for f in ("use_la", "use_ga", "use_egla")
                   if not getattr(self, f)]
        if self.fused_egla and no_egla:
            raise ValueError(
                f"fused_egla=True with {no_egla[0]}=False: the fused EGLA "
                "kernels are the full EGLA's, which this ablation replaces")
        if self.fused_egla and self.mask_mode == "sample":
            raise ValueError(
                "fused_egla=True needs mask_mode='expected': the fused EGLA "
                "composes a per-(frame, channel) mask into its q projection, "
                "and cdfo_tpu ignores the flag under the sampled mask")
        if self.fused_align and not (self.use_mv and self.use_pd):
            raise ValueError(
                "fused_align=True needs use_mv and use_pd: the fused dual "
                "MSA runs both branches (cdfo_tpu takes it only then)")
        if self.fused_align and not self.fused_trunk:
            raise ValueError(
                "fused_align=True needs fused_trunk=True: the fused dual MSA "
                "feeds the fused alignment tail (cdfo_tpu reaches it only "
                "under fused_trunk and would ignore the flag otherwise)")
        if self.block_warp and not self.use_mv:
            raise ValueError(
                "block_warp=True with use_mv=False: woMV runs no neighbour "
                "warp")

    @property
    def center(self) -> int:
        return self.nframes // 2

    @property
    def v8_family(self) -> bool:
        """CVSR_V8 or one of its ablations (the streaming engine's models)."""
        return self.name in V8_NAMES


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
    fields are left out: a data-parallel run spans the process group's
    ranks (``parallel/mesh.py``, ``train/loop.py``); so are its unread
    ``warm_start_epoch`` and ``bf16_compute``."""

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
