"""Unrolled-trunk <-> scan-trunk parameter layouts of ``cdfo_tpu`` flax
trees (numpy copies of ``cdfo_tpu/compat/scan_params.py``, which imports
JAX).

The unrolled trunks (``SCNetS`` / ``SCNetPyr``) name their groups
``body_{i}``, the reference's torch names. ``cdfo_tpu``'s scan twins
(``SCNetSScan`` / ``SCNetPyrScan``) hold one stacked copy of the group
tree under ``groups/g``, with a leading ``num_groups`` axis. The port's
scan trunks keep the unrolled names, so ``from_flax`` unstacks a scan tree
(``from_scan_trunk``) before it maps the keys.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np


def _is_unrolled_trunk(sub: Dict[str, Any]) -> bool:
    return any(re.fullmatch(r"body_\d+", k) for k in sub) and \
        "groups" not in sub


def _tree_map(fn, *trees):
    """``jax.tree.map`` over nested dicts of arrays."""
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _stack_subtree(sub: Dict[str, Any]) -> Dict[str, Any]:
    names = sorted((k for k in sub if re.fullmatch(r"body_\d+", k)),
                   key=lambda s: int(s.split("_")[1]))
    stacked = _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *[sub[k] for k in names])
    out = {k: v for k, v in sub.items() if k not in names}
    out["groups"] = {"g": stacked}
    return out


def _unstack_subtree(sub: Dict[str, Any]) -> Dict[str, Any]:
    stacked = sub["groups"]["g"]
    n = int(np.asarray(next(_leaves(stacked))).shape[0])
    out = {k: v for k, v in sub.items() if k != "groups"}
    for i in range(n):
        out[f"body_{i}"] = _tree_map(lambda x: np.asarray(x)[i], stacked)
    return out


def _map_trunk(params: Any, fn, trunk_name: str) -> Any:
    def walk(node):
        if not isinstance(node, Mapping):
            return node
        return {k: fn(v) if k == trunk_name and isinstance(v, Mapping)
                else walk(v) for k, v in node.items()}

    return walk(params)


def to_scan_trunk(params: Any, trunk_name: str = "recon_trunk") -> Any:
    """Every ``trunk_name`` subtree from the unrolled ``body_{i}`` layout to
    the scan ``groups/g`` layout (a scan subtree is left as it is)."""
    return _map_trunk(
        params, lambda sub: _stack_subtree(sub) if _is_unrolled_trunk(sub)
        else sub, trunk_name)


def from_scan_trunk(params: Any, trunk_name: str = "recon_trunk") -> Any:
    """The inverse of :func:`to_scan_trunk`."""
    return _map_trunk(
        params, lambda sub: _unstack_subtree(sub) if "groups" in sub
        else sub, trunk_name)
