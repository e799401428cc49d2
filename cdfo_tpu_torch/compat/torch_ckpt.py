"""Released CDFO checkpoints (``.pth`` ``state_dict``s of the reference's
`arch/SIDECVSR_our.py` models, e.g. ``LD_QP37_J_epoch-9500.pth``,
`test_LD_37.py:123`) into the port's ``CVSRV8``.

The port's parameters carry the reference's ``state_dict`` names and
layouts, so a checkpoint loads by name. Keys of reference submodules that
are built but never called have no parameter here and are dropped (the
patterns of ``cdfo_tpu/compat/torch_convert.py``); any other key the model
lacks, any parameter the checkpoint lacks and any shape that differs
raises, naming the keys.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# torch keys that exist in reference checkpoints but have no live parameter
KNOWN_DEAD_PATTERNS = [
    r".*\.fusion_in\..*",          # DualAttAlignment dead branch (:3445)
    r".*conv_offset_mask\..*",     # unused pack head under MV*Alignment
    r".*\.adaptiveWeight.*",       # PAItransformer wrapper lamRes/lamX
]


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth state_dict to numpy (CPU, no torch tensors escape)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().numpy() for k, v in sd.items()}


def is_dead_key(key: str) -> bool:
    return any(re.fullmatch(pat, key) for pat in KNOWN_DEAD_PATTERNS)


def load_reference_state_dict(model: torch.nn.Module,
                              state_dict: Mapping[str, object]) -> list[str]:
    """Copies a reference ``state_dict`` (name -> array or tensor) into
    ``model`` in place, each value cast to its parameter's dtype and
    device; returns the dead keys it dropped. Raises ``KeyError`` for an
    unknown or a missing key and ``ValueError`` for a shape that
    differs."""
    own = model.state_dict()
    dead = sorted(k for k in state_dict if k not in own and is_dead_key(k))
    unknown = sorted(k for k in state_dict if k not in own and k not in dead)
    missing = sorted(k for k in own if k not in state_dict)
    if unknown or missing:
        raise KeyError(f"checkpoint keys the model lacks: {unknown}; model "
                       f"parameters the checkpoint lacks: {missing}")
    values = {}
    for key, ref in own.items():
        value = torch.as_tensor(np.asarray(state_dict[key]))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, "
                             f"the model's {tuple(ref.shape)}")
        values[key] = value
    model.load_state_dict(values)
    return dead


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> list[str]:
    """``load_reference_state_dict`` of the ``.pth`` file at ``path``."""
    return load_reference_state_dict(model, load_torch_checkpoint(path))
