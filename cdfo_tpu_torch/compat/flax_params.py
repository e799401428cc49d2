"""``cdfo_tpu`` flax params -> the port's torch ``state_dict``.

The port's parameter names are the reference torch ``state_dict`` keys, the
names ``cdfo_tpu.compat.torch_convert.flax_to_torch_key`` emits. That module
cannot be imported without JAX, so its key mapping is copied here (the part
the model zoo reaches) and each array transform is inverted:

  conv kernel (kh, kw, in, out)            -> weight (out, in, kh, kw)
  conv-transpose kernel (kh, kw, in, out)  -> weight (in, out, kh, kw)
  LayerNorm {weight, bias}                 -> body.{weight, bias}
  raw DCN weight (kh, kw, in, out)         -> weight (out, in, kh, kw)
  EGLA 9-tap directW1/directH1 vectors     -> (1, 1, 1, 9) / (1, 1, 9, 1)
  EGLA1 9-tap directW/directH vectors      -> (1, 1, 9, 1) / (1, 1, 1, 9)
                                              weights and (1,) biases
  flax ``name_N`` Sequential names         -> torch ``name.N``

A variant wrapper's leading ``body`` scope (CVSR_V9's) has no torch
counterpart and is dropped; a scan trunk's stacked ``groups/g`` tree is
unstacked into the unrolled ``body_{i}`` groups first
(``scan_params.from_scan_trunk``).
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from .scan_params import from_scan_trunk

# flax module names whose trailing _N maps to a torch Sequential index
_SEQUENTIAL = {
    "body", "down", "up", "conv_du", "conv_du_re", "conv_du_re2", "conv_dc",
    "conv_df", "conv_du_am", "fusion_out", "fc", "conv_attention",
    "offset_mask", "input_conv", "kernel_pred_module", "channel_add_conv",
    "conv_offset", "fcs", "conv_match1", "conv_match2", "conv_assembly",
    "scaleing", "off2flow", "offset_oc", "out_conv", "spatial",
}

_RENAMES = {
    "transformer_feature_extraction": "transformer_feature_extraction.path1",
}

# EGLA's (1, 9) / (9, 1) convs; EGLA1 swaps them: its directW_conv is (9, 1)
# along positions, its directH_conv (1, 9) along channels
_DIRECT_SHAPES = {"directW1": (1, 1, 1, 9), "directH1": (1, 1, 9, 1),
                  "directW": (1, 1, 9, 1), "directH": (1, 1, 1, 9)}


def _segment_to_torch(seg: str) -> str:
    if seg in _RENAMES:
        return _RENAMES[seg]
    m = re.fullmatch(r"([A-Za-z][A-Za-z0-9_]*?)_(\d+)", seg)
    if m and m.group(1) in _SEQUENTIAL:
        return f"{m.group(1)}.{m.group(2)}"
    return seg


def _join(segs) -> str:
    return ".".join(_segment_to_torch(s) for s in segs)


def flax_to_torch(path: Tuple[str, ...], norm: bool = False
                  ) -> Tuple[str, Callable]:
    """Map a flax param path to (torch state_dict key, flax -> torch array
    transform). ``norm``: the leaf belongs to a ChannelLayerNorm (whose
    params are a ``weight`` and a ``bias``); a ``weight`` leaf outside one
    is a deformable conv's raw weight."""
    segs = [s for s in path if s != "msa"]  # _GateMSA params live flat
    if segs[0] == "body":   # a variant wrapper's scope (CVSR_V9)
        segs = segs[1:]
    leaf = segs[-1]

    def t_conv(a):  # (kh, kw, in/g, out) -> (out, in/g, kh, kw)
        return np.transpose(a, (3, 2, 0, 1))

    def t_conv_t(a):  # (kh, kw, in, out) -> (in, out, kh, kw)
        return np.transpose(a, (2, 3, 0, 1))

    def identity(a):
        return a

    def key(base, name):
        return f"{base}.{name}" if base else name

    if leaf == "temperature":
        return key(_join(segs[:-1]), "temperature"), identity
    if len(segs) >= 2 and segs[-2] == "conv" and leaf in ("kernel", "bias"):
        base = _join(segs[:-2])
        if leaf == "kernel":
            return key(base, "weight"), t_conv
        return key(base, "bias"), identity
    if leaf == "kernel":  # ConvTranspose2d stores a bare kernel
        return key(_join(segs[:-1]), "weight"), t_conv_t
    if norm and leaf in ("weight", "bias"):
        return key(_join(segs[:-1]), f"body.{leaf}"), identity
    if leaf == "weight":  # a deformable conv's raw (kh, kw, in, out)
        return key(_join(segs[:-1]), "weight"), t_conv
    if leaf == "bias":  # ConvTranspose2d or deformable conv bias
        return key(_join(segs[:-1]), "bias"), identity
    m = re.fullmatch(r"(direct[WH]1?)_(kernel|bias)", leaf)
    if m:
        name, kind = m.groups()
        base = _join(segs[:-1])
        if kind == "kernel":
            shape = _DIRECT_SHAPES[name]
            return key(base, f"{name}_conv.weight"), lambda a: a.reshape(shape)
        return key(base, f"{name}_conv.bias"), lambda a: a.reshape(1)
    raise KeyError(f"no rule for flax path {path}")


def _is_dcn(prefix) -> bool:
    """A deformable conv's scope: its ``weight`` is a raw conv weight
    (``cdfo_tpu``'s converter's rule: ``mdc`` / ``dc`` packs and the
    ``*deform_align`` aligners)."""
    return bool(prefix) and (prefix[-1] in ("mdc", "dc")
                             or prefix[-1].endswith("deform_align"))


def _flatten(tree: Mapping[str, Any], prefix=()):
    """Yields (path, leaf, norm); a dict holding a ``weight`` leaf is a
    LayerNorm (convolutions hold a ``kernel``), unless it is a deformable
    conv's."""
    norm = "weight" in tree and not _is_dcn(prefix)
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v, norm


def from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``cdfo_tpu`` params (a nested dict of numpy arrays, with or without
    the top-level ``"params"`` collection) -> torch ``state_dict`` of
    float32 CPU tensors, for ``module.load_state_dict``."""
    if set(params) == {"params"}:
        params = params["params"]
    params = from_scan_trunk(params)
    sd = {}
    for path, leaf, norm in _flatten(params):
        tkey, transform = flax_to_torch(path, norm)
        if tkey in sd:
            raise KeyError(f"two flax params map to {tkey}")
        arr = transform(np.asarray(leaf, np.float32))
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd
