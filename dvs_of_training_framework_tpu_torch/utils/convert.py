"""Convert parameters between the JAX package's flax tree and the port.

A flax tree (nested mappings of arrays, e.g. ``params['predictor']['enc0']
['kernel']``) maps name by name onto the port's ``state_dict``
(``predictor.enc0.weight``):

- a conv ``kernel`` (4-D, HWIO) becomes ``weight`` in OIHW;
- a ``DenseParams`` ``kernel`` (2-D, ``[in, out]``) keeps its name and its
  layout, which the K2 kernel reads as is;
- every ``bias`` keeps its name and layout.

Both directions copy the values exactly.
"""
from collections.abc import Mapping

import numpy as np
import torch


def flax_to_torch(params: Mapping) -> dict:
    """Flatten a flax parameter tree into the port's state_dict."""
    out = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            array = np.array(value)
            if key == 'kernel' and array.ndim == 4:
                key, array = 'weight', array.transpose(3, 2, 0, 1)
            out['.'.join(prefix + (key,))] = torch.from_numpy(
                np.ascontiguousarray(array))

    walk(params, ())
    return out


def torch_to_flax(state_dict: Mapping) -> dict:
    """Nest the port's state_dict into a flax tree of numpy arrays."""
    tree = {}
    for name, tensor in state_dict.items():
        *path, key = name.split('.')
        array = tensor.detach().cpu().numpy()
        if key == 'weight':
            key, array = 'kernel', array.transpose(2, 3, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(array)
    return tree


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy a flax parameter tree into ``model`` (every name must match)."""
    model.load_state_dict(flax_to_torch(params), strict=True)
