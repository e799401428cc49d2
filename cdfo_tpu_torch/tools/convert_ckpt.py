"""A released CDFO ``.pth`` into the port's training checkpoint, and back
(the port of ``tools/convert_ckpt.py``)::

    python -m cdfo_tpu_torch.tools.convert_ckpt --pth LD_QP37.pth --out DIR
    python -m cdfo_tpu_torch.tools.convert_ckpt --inverse \\
        --ckpt DIR/step_00000000.pt --out back.pth

The forward direction loads the ``.pth`` (its ``state_dict``, under the
reference's key names) into ``build_model(--model)`` on the CPU, dropping
the reference's dead keys (``compat/torch_ckpt.py``), and writes
``DIR/step_%08d.pt`` (``--step``, 0 by default), the checkpoint that
``train/loop.py`` resumes from and ``tools.test_sr --ckpt`` reads: the
model, its float32 masters, a fresh Adam state and the step.
``--inverse`` writes a port checkpoint's weights (its float32 masters) as a
``.pth`` ``state_dict`` under the reference names. An unknown or a missing
key, or a shape that differs, raises and names the keys; a round trip
gives the live keys back bit for bit. Host code: it runs on the CPU.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..compat.torch_ckpt import load_reference_state_dict, load_torch_checkpoint
from ..config import MODEL_NAMES, ModelConfig, TrainConfig
from ..models import build_model
from ..train.loop import restore_checkpoint, save_checkpoint
from ..train.state import TrainState


def _model(name: str, cfg: ModelConfig | None):
    return build_model(name, cfg or ModelConfig(name=name), device="cpu")


def pth_to_checkpoint(state_dict, out_dir: str, model: str = "cvsr_v8",
                      step: int = 0, cfg: ModelConfig | None = None) -> str:
    """A reference ``state_dict`` (name -> array or tensor) as the port's
    ``out_dir/step_%08d.pt``; returns its path."""
    net = _model(model, cfg)
    load_reference_state_dict(net, state_dict)
    state = TrainState(net, TrainConfig())
    state.step = step
    return save_checkpoint(out_dir, state)


def checkpoint_to_state_dict(path: str, model: str = "cvsr_v8",
                             cfg: ModelConfig | None = None) -> dict:
    """The weights of the port checkpoint at ``path`` as a reference
    ``state_dict`` of float32 CPU tensors (the masters: a bfloat16 model's
    float32 copies)."""
    net = _model(model, cfg)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state_dict(net, blob["model"])
    state = TrainState(net, TrainConfig())
    restore_checkpoint(path, state)
    masters = {id(p): m for p, m in zip(state.params, state.masters)}
    out = {}
    for name, t in net.state_dict(keep_vars=True).items():
        out[name] = masters.get(id(t), t).detach().float().clone()
    return out


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pth", help="a released .pth (forward direction)")
    p.add_argument("--ckpt", help="a port step_%%08d.pt (with --inverse)")
    p.add_argument("--out", required=True,
                   help="the checkpoint directory, or the .pth to write")
    p.add_argument("--inverse", action="store_true")
    p.add_argument("--model", default="cvsr_v8", choices=MODEL_NAMES)
    p.add_argument("--step", type=int, default=0)
    args = p.parse_args(argv)
    if args.inverse:
        if not args.ckpt:
            p.error("--inverse needs --ckpt")
        sd = checkpoint_to_state_dict(args.ckpt, args.model)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        torch.save(sd, args.out)
        print(f"wrote {len(sd)} tensors to {args.out}")
        return args.out
    if not args.pth:
        p.error("give --pth (or --inverse --ckpt)")
    path = pth_to_checkpoint(load_torch_checkpoint(args.pth), args.out,
                             args.model, args.step)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
