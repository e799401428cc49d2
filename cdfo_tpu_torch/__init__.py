"""cdfo_tpu_torch — the PyTorch/CUDA port of ``cdfo_tpu`` for NVIDIA Hopper.

It mirrors ``cdfo_tpu``'s module paths and class names and keeps its NHWC
layout at every public function. It imports torch and numpy, never JAX:
the JAX package stays the reference that the port is tested against.
"""

from .config import DataConfig, ModelConfig, TrainConfig

__all__ = ["DataConfig", "ModelConfig", "TrainConfig"]
