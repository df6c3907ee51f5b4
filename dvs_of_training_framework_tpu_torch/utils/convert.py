"""Convert parameters between the JAX package's flax tree and the port.

A flax tree (nested mappings of arrays, e.g. ``params['predictor']['enc0']
['kernel']``) maps name by name onto the port's ``state_dict``
(``predictor.enc0.weight``):

- a conv ``kernel`` (4-D, HWIO) becomes ``weight`` in OIHW;
- a ``DenseParams`` ``kernel`` (2-D, ``[in, out]``) keeps its name and its
  layout, which the K2 kernel reads as is;
- every ``bias`` keeps its name and layout.

Both directions copy the values exactly.  ``optax_state_to_torch`` maps
the JAX package's optimizer state onto the port's
``Optimizer.state_dict()`` the same way, so a run can carry its whole
train state across.
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


def _fields(node):
    """A NamedTuple's fields as a dict, None for anything else."""
    if isinstance(node, tuple) and hasattr(node, '_fields'):
        return dict(zip(node._fields, node))
    return None


def _find(tree, field):
    """The NamedTuples under ``tree`` (depth first) that have ``field``."""
    found = []
    fields = _fields(tree)
    if fields is not None and field in fields:
        found.append(fields)
    children = (fields.values() if fields is not None
                else tree.values() if isinstance(tree, Mapping)
                else tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        found.extend(_find(child, field))
    return found


def _prune(tree):
    """A parameter-shaped tree without the leaves masked out of a group
    (optax's ``MaskedNode``, which has no shape)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            value = _prune(value)
            if value:
                out[key] = value
        elif hasattr(value, 'shape'):
            out[key] = value
    return out


def optax_state_to_torch(opt_state, model: torch.nn.Module) -> dict:
    """The port's ``Optimizer.state_dict()`` for a JAX package optimizer
    state of ADAM, RADAM or RANGER over the two groups, with or without
    the clip and EMA riders, on the devices of ``model``'s parameters.

    Each group's ``count``, ``mu`` and ``nu`` come from its moments state
    (optax ``scale_by_radam`` or ``scale_by_amsgrad``, whose ``nu_max``
    holds the running maximum of the bias-corrected second moment, as
    the port's does), ``slow`` from its ``LookaheadState``, and
    ``ema_params`` from ``ParamEmaState``.
    """
    devices = {n: p.device for n, p in model.named_parameters()}

    def tensors(tree):
        return {n: t.to(devices[n]) for n, t in
                flax_to_torch(_prune(tree)).items()}

    groups = {}
    (multi,) = _find(opt_state, 'inner_states')
    for key, group_state in multi['inner_states'].items():
        (moments,) = _find(group_state, 'mu')
        state = {'count': int(np.asarray(moments['count'])),
                 'mu': tensors(moments['mu']), 'nu': tensors(moments['nu'])}
        if 'nu_max' in moments:
            state['nu_max'] = tensors(moments['nu_max'])
        lookahead = _find(group_state, 'slow_params')
        if lookahead:
            state['slow'] = tensors(lookahead[0]['slow_params'])
        groups[key] = state
    out = {'groups': groups}
    ema = _find(opt_state, 'ema_params')
    if ema:
        out['ema_params'] = tensors(ema[0]['ema_params'])
    return out
