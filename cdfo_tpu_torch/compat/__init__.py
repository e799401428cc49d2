from .flax_params import flax_to_torch, from_flax
from .torch_ckpt import (load_reference_checkpoint, load_reference_state_dict,
                         load_torch_checkpoint)

__all__ = ["flax_to_torch", "from_flax", "load_reference_checkpoint",
           "load_reference_state_dict", "load_torch_checkpoint"]
