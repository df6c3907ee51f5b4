"""Utilities of the port."""
from .convert import flax_to_torch, load_flax_params, torch_to_flax

__all__ = ['flax_to_torch', 'load_flax_params', 'torch_to_flax']
