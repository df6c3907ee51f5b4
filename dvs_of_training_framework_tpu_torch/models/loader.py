"""Model plugins: loading by name or path, kwargs filtering, construction.

The port's copy of ``dvs_of_training_framework_tpu/models/loader.py``
(reference utils/model.py:26-47).  A plugin is named by
``--flownet_path``; construction kwargs offered by the CLI are filtered
against the ``Model``'s accepted parameters, so a plugin declares only
what it uses.

Name resolution: a path whose directory name is ``EVFlowNet``,
``RecurrentFlowNet``, ``DummyFlowNet`` or ``ERAFT`` (wherever it points)
resolves to the port's own module of that name (``models/evflownet.py``,
``models/recurrent_flownet.py``, ``models/dummy_flownet.py``,
``models/eraft.py``); the repo's root plugin directories of the first
three names hold the JAX plugins and are never imported (the JAX package
has no E-RAFT).  Any other directory is imported as a torch plugin: its
``net.py`` for the model, its ``__init__.py`` for the inference wrapper,
its ``test.py`` for the flow rendering.

Plugin contract of the port:

- ``Model`` is a ``torch.nn.Module`` built as ``Model(**kwargs,
  generator=torch.Generator, device=...)`` whose ``forward(events,
  timestamps, sample_idx, imsize, raw=True, intermediate=False)`` returns
  ``(flows, flow_ts, flow_sample_idx[, features])``, ``flows`` a tuple of
  ``[B, 2, H/2^i, W/2^i]`` tensors for i = 3..0; with ``raw=False``
  ``events`` is a dense float32 ``[B, C, H, W]`` tensor (``--ev_images``,
  baked shards), which the model casts to its compute type; a plugin
  may need a number of elements a sample (E-RAFT reads two event volumes:
  ``--max-sequence-length 2 --prefix-length 1``), and raises at
  construction for another;
- ``Model.quantize(events, timestamps, sample_idx, imsize)`` gives the
  dense float32 representation of a raw batch, as baked by
  ``tools/quantize_preprocessed.py``;
- the module's ``compute_event_image(events, start_ts, stop_ts, shape,
  depth=9)`` turns one sample's ``[N, 5]`` event rows into its
  ``[L, depth, H, W]`` float32 image on the host (``--ev_images`` over
  raw data);
- an optional submodule ``quantization_layer`` makes its parameters the
  representation group of the optimizer, with its delayed schedule
  (reference train_flownet.py:50-54, 78-109); without one the optimizer
  has one group;
- its parameters of two or more dimensions belong to the port's ``Conv``
  or ``DenseParams``, ``torch.nn.Conv2d`` (or a subclass) or
  ``torch.nn.Linear``, whose output axes ``output_axes`` knows; a
  normalisation layer's scale and shift are leaves of one dimension,
  which the optimizer does not centralise;
- its buffers (batch norm's running statistics) are updated in place,
  where a captured window's graph updates them too; buffers registered
  non-persistent stay out of ``state_dict()``, so the parameters alone
  load strictly, and a checkpoint stores them beside it
  (``training/hooks.py``);
- ``OpticalFlow`` (a ``BaseOpticalFlow``) is its inference wrapper;
- ``vis_flow(flow)`` renders one ``[H, W, 2]`` float32 flow field as a
  BGR uint8 image (the four plugins: ``utils/visualization.flow2img``
  of its two channels), for the visualize CLI's panels.
"""
import importlib
import importlib.util
import inspect
import logging
from pathlib import Path
import sys

import torch

from ..utils.options import options2model_kwargs

# plugin directory name -> the port's module of that plugin
PORT_PLUGINS = {'EVFlowNet': 'evflownet',
                'RecurrentFlowNet': 'recurrent_flownet',
                'DummyFlowNet': 'dummy_flownet',
                'ERAFT': 'eraft'}


def filter_kwargs(func, kwargs):
    """Restrict kwargs to the parameters ``func`` accepts (all of them if
    it takes ``**kwargs``)."""
    parameters = inspect.signature(func).parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD
           for p in parameters.values()):
        return kwargs
    dropped = [k for k in kwargs if k not in parameters]
    if dropped:
        logging.warning(f'{dropped} are filtered out from model parameters!')
    return {k: v for k, v in kwargs.items() if k in parameters}


def import_module(module_name, module_path):
    """Import a python module from an explicit file path."""
    module_path = Path(module_path)
    if not module_path.is_file():
        raise FileNotFoundError(f'Module file {module_path} not found')
    # make sibling modules of the plugin importable (net.py imports etc.)
    pkg_dir = str(module_path.parent.parent.resolve())
    if pkg_dir not in sys.path:
        sys.path.insert(0, pkg_dir)
    spec = importlib.util.spec_from_file_location(module_name, module_path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def _port_module(flownet_path):
    name = PORT_PLUGINS.get(Path(flownet_path).name)
    if name is None:
        return None
    return importlib.import_module(f'{__package__}.{name}')


def load_model_class(flownet_path):
    """The module holding the plugin's ``Model``."""
    flownet_path = Path(flownet_path)
    return _port_module(flownet_path) or import_module(
        f'{flownet_path.name}.net', flownet_path / 'net.py')


def load_plugin(flownet_path):
    """The module holding the plugin's ``OpticalFlow``."""
    flownet_path = Path(flownet_path)
    return _port_module(flownet_path) or import_module(
        flownet_path.name, flownet_path / '__init__.py')


def load_vis_flow(flownet_path):
    """The plugin's ``vis_flow``: the port module's for the four
    plugin names, else the one in the directory's ``test.py``."""
    flownet_path = Path(flownet_path)
    module = _port_module(flownet_path) or import_module(
        f'{flownet_path.name}.test', flownet_path / 'test.py')
    return module.vis_flow


def init_model(args, device):
    """The plugin's ``Model`` from ``args``: ``options2model_kwargs``
    filtered to what it accepts, seeded from ``--init-seed`` (0 for a
    parser without it, as the bake tool's), in
    ``--precision`` where it takes a ``dtype``, on ``device``, with the
    ``-sp`` weights (of the port or of the JAX package) when given."""
    module = load_model_class(args.flownet_path)
    kwargs = filter_kwargs(module.Model, options2model_kwargs(args))
    model = module.Model(
        generator=torch.Generator().manual_seed(
            getattr(args, 'init_seed', 0)),
        device=device, **kwargs)
    if getattr(args, 'sp', None) is not None:
        from ..training.serializer import read_params_file
        model.load_state_dict(read_params_file(args.sp), strict=True)
    return model


def output_axes(model):
    """Output axis of every parameter, None for one of fewer than two
    dimensions: axis 0 of a conv weight ``[out, in, kh, kw]`` or a linear
    weight ``[out, in]``, axis 1 of a dense kernel ``[in, out]``.  The
    optimizer's gradient centralisation averages over the other axes, as
    the JAX package's averages over all but a leaf's last (output) axis."""
    from .evflownet import Conv, DenseParams
    axes = {}
    for prefix, module in model.named_modules():
        for leaf, param in module.named_parameters(recurse=False):
            name = f'{prefix}.{leaf}' if prefix else leaf
            if param.dim() < 2:
                axes[name] = None
            elif isinstance(module, DenseParams):
                axes[name] = 1
            elif isinstance(module, (Conv, torch.nn.Conv2d,
                                     torch.nn.Linear)):
                axes[name] = 0
            else:
                raise ValueError(f'{name}: no known output axis for a '
                                 f'{type(module).__name__} parameter')
    return axes
