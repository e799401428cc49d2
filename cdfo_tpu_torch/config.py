"""Model configuration of the PyTorch port (mirrors ``cdfo_tpu.config``).

The port runs these slices of the JAX package: CVSR_V8 with the
noise-free EGLA mask, in float32 or bfloat16, with ``fused_trunk`` (the
trunk, the upsample head and the alignment tail as hand-written kernels on
a GPU), ``fused_embed`` (the GCPI rounds' MDTA), ``fused_align`` (the dual
MSA; it needs ``fused_trunk``, as the JAX model reaches it only there) and
``fused_egla`` (EGLA; it needs only the noise-free mask, the port's only
one) each off or on; ``trunk_int8`` (the int8 trunk kernel; it needs
``fused_trunk``, under which alone the JAX model reads it) and
``block_warp`` (the block-gather neighbour warp) likewise. The four fused
flags with ``trunk_int8`` are the JAX headline configuration; without it,
its exact-trunk side-by-side. ``scan_trunk`` is off. A setting outside
those slices raises naming the work that would add it, so nothing silently
ignores a field.
"""
from __future__ import annotations

import dataclasses

import torch

_LATER = {
    "scan_trunk": "the scan trunk (ROADMAP Queue 1, item 1.6, model zoo)",
}
_ABLATIONS = ("use_pab", "use_la", "use_ga", "use_mv", "use_pd", "use_egla")
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """CVSR_V8 hyper-parameters; field names and meanings follow
    ``cdfo_tpu.config.ModelConfig``.

    ``mask_mode`` defaults to ``"expected"`` here (the JAX default is
    ``"sample"``): the stochastic gumbel mask is not ported yet.
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
        if self.mask_mode != "expected":
            raise NotImplementedError(
                f"mask_mode={self.mask_mode!r}: only the noise-free "
                "'expected' EGLA mask is ported; the gumbel 'sample' mask "
                "is not ported yet (ROADMAP Queue 1, item 1.2)")
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
