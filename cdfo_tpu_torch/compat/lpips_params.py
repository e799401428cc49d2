"""``cdfo_tpu``'s flax LPIPS and ranking-net params -> the port's torch
``state_dict``s (``metrics/lpips.py``, ``metrics/lpips_train.py``).

Arrays arrive as numpy (with or without the top-level ``params`` scope):

  net/conv{i}/{kernel (kh, kw, in, out), bias}
      -> net.features.<torchvision index>.{weight (out, in, kh, kw), bias}
  net/fire{i}/{squeeze, expand1, expand3}
      -> net.features.<index>.{squeeze, expand1x1, expand3x3}
  lin{i}/kernel (1, 1, C, 1)         -> lin{i}.model.1.weight (1, C, 1, 1)
  Dist2LogitLayer conv{0,1,2}        -> model.{0,2,4}
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..metrics.lpips import (ALEX_CONVS, SQUEEZE_FIRES, TRUNKS, VGG16_CONVS)

_CONV_INDEX = {"vgg": [i for i, _ in VGG16_CONVS],
               "alex": [c[0] for c in ALEX_CONVS],
               "squeeze": [0]}
_FIRE_INDEX = [f[0] for f in SQUEEZE_FIRES]
_FIRE_CONVS = {"squeeze": "squeeze", "expand1": "expand1x1",
               "expand3": "expand3x3"}


def _conv(prefix: str, p: Mapping) -> dict:
    out = {f"{prefix}.weight": torch.tensor(
        np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"]))
    return out


def lpips_from_flax(params: Mapping, net: str) -> dict:
    """The port's ``LPIPS(net)`` ``state_dict`` (parameters only) from
    ``cdfo_tpu``'s ``LPIPS(net=net)`` params."""
    if net not in TRUNKS:
        raise ValueError(f"net={net!r}: one of {tuple(TRUNKS)}")
    p = params.get("params", params)
    out = {}
    for i, idx in enumerate(_CONV_INDEX[net]):
        out.update(_conv(f"net.features.{idx}", p["net"][f"conv{i}"]))
    if net == "squeeze":
        for i, idx in enumerate(_FIRE_INDEX):
            fire = p["net"][f"fire{i}"]
            for src, dst in _FIRE_CONVS.items():
                out.update(_conv(f"net.features.{idx}.{dst}", fire[src]))
    for i in range(len(TRUNKS[net][1])):
        out.update(_conv(f"lin{i}.model.1", p[f"lin{i}"]))
    return out


def dist2logit_from_flax(params: Mapping) -> dict:
    """The port's ``Dist2LogitLayer`` ``state_dict`` from ``cdfo_tpu``'s."""
    p = params.get("params", params)
    out = {}
    for i in range(3):
        out.update(_conv(f"model.{2 * i}", p[f"conv{i}"]))
    return out
