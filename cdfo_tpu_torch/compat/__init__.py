from .flax_params import flax_to_torch, from_flax

__all__ = ["flax_to_torch", "from_flax"]
