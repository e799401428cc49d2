"""The model zoo (counterpart of ``cdfo_tpu/models/__init__.py``):
``MODEL_REGISTRY`` maps each of ``cdfo_tpu``'s registry names to a
function ``(cfg=None, generator=None, device="cuda", **kw)`` that builds
the model. Without ``cfg`` it takes the name's ``ModelConfig`` (an
ablation's flag off; 4 trunk groups for SIDECVSR, 7 for the others);
without ``generator`` the weights come from
``torch.Generator().manual_seed(0)``. Models are built on the card unless
``device`` asks for another."""
from __future__ import annotations

import dataclasses

import torch

from ..config import MODEL_NAMES, ModelConfig
from .cvsr import CVSRV8
from .cvsr_variants import CVSRV7, CVSRV9, SIDECVSRModel

_CLASSES = {"cvsr_v7": CVSRV7, "cvsr_v9": CVSRV9, "sidecvsr": SIDECVSRModel}


def _build_fn(name: str):
    cls = _CLASSES.get(name, CVSRV8)

    def build(cfg: ModelConfig | None = None,
              generator: torch.Generator | None = None,
              device: torch.device | str = "cuda", **kw):
        cfg = cfg or ModelConfig(name=name)
        if cfg.name != name:
            cfg = dataclasses.replace(cfg, name=name)
        return cls(cfg, generator or torch.Generator().manual_seed(0),
                   device=device, **kw)

    return build


MODEL_REGISTRY = {name: _build_fn(name) for name in MODEL_NAMES}


def build_model(name: str, cfg: ModelConfig | None = None,
                generator: torch.Generator | None = None,
                device: torch.device | str = "cuda", **kw):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg, generator, device, **kw)


__all__ = ["CVSRV7", "CVSRV8", "CVSRV9", "SIDECVSRModel", "MODEL_REGISTRY",
           "build_model"]
