from .flax_params import flax_to_torch, from_flax
from .lpips_params import dist2logit_from_flax, lpips_from_flax
from .torch_ckpt import (load_reference_checkpoint, load_reference_state_dict,
                         load_torch_checkpoint)

__all__ = ["dist2logit_from_flax", "flax_to_torch", "from_flax",
           "lpips_from_flax", "load_reference_checkpoint",
           "load_reference_state_dict", "load_torch_checkpoint"]
