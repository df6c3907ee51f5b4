"""Utilities of the port."""
from .convert import (flax_to_torch, load_flax_params, optax_state_to_torch,
                      torch_to_flax)

__all__ = ['flax_to_torch', 'load_flax_params', 'optax_state_to_torch',
           'torch_to_flax']
