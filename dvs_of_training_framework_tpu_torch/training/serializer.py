"""Step-indexed checkpoint store with a rolling window and permanent keeps.

Counterpart of ``dvs_of_training_framework_tpu/training/serializer.py``,
with the same API and retention policy: checkpoints named after a
one-argument template (``step_{}.ckpt``), the newest
``keep_checkpoints_max`` kept, every ``permanent_checkpoint_interval``-th
step kept for good, rediscovery by file name on start, and ``finalize`` to
export a weights-only file.

Storage is ``torch.save`` of one dict a step: ``model`` (the model's
``state_dict``), ``optimizer`` (the optimizer's ``state_dict``, the EMA
included), ``global_step`` and the caller's extras such as
``samples_passed`` and ``buffers``.  Every tensor is copied to the host
before the write, so the file holds the state as it was at the call; it
is written to a ``.tmp`` file and moved into place, and read back with
``weights_only=True``: only tensors, numbers, strings and containers.

``read_params_file`` also reads the JAX package's msgpack checkpoints and
weights-only exports, decoded without flax, and maps them through
``utils.convert.flax_to_torch``.  A file in the other framework's format
where a loader expects its own raises an error that names the format.
"""
import logging
import math
import os
import re
import threading
import typing
from pathlib import Path

import numpy as np
import torch

from ..utils.convert import flax_to_torch

_ZIP_MAGIC = b'PK\x03\x04'      # torch.save's format is a zip archive


def parse_template(template: str, value: str):
    """The groups that ``template``'s ``{}`` fields match in ``value``, or
    None when it does not match."""
    pattern = re.escape(template).replace(r'\{\}', '(.+?)')
    match = re.fullmatch(pattern, value)
    return None if match is None else list(match.groups())


def file_format(path) -> str:
    """'torch' (a ``torch.save`` zip archive), 'msgpack' (a map, as the
    JAX package writes) or 'unknown', from the file's first bytes."""
    with open(path, 'rb') as f:
        head = f.read(4)
    if head == _ZIP_MAGIC:
        return 'torch'
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return 'msgpack'
    return 'unknown'


def to_host(tree):
    """A copy of ``tree`` with every tensor detached and copied to the
    host, so later in-place updates of the live tensors do not reach it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _write(path, state: dict):
    tmp = Path(str(path) + '.tmp')
    torch.save(state, tmp)
    os.replace(tmp, path)


def save_state_file(path, state_dict: dict):
    _write(path, to_host(state_dict))


def load_state_file(path) -> dict:
    """Read a file that ``save_state_file`` wrote; raises ``ValueError``
    for a file in another format."""
    kind = file_format(path)
    if kind != 'torch':
        what = ('a msgpack file of the JAX package (read its weights with '
                'read_params_file)' if kind == 'msgpack'
                else 'not a torch.save archive')
        raise ValueError(f'{path} is {what}')
    return torch.load(path, map_location='cpu', weights_only=True)


def _decode_msgpack(data: bytes):
    """The tree of a flax ``msgpack_serialize`` file, with numpy leaves.
    flax packs an array as ext type 1 and a numpy scalar as ext type 3,
    each holding ``(shape, dtype name, bytes)``."""
    import msgpack

    def ext_hook(code, payload):
        if code not in (1, 3):
            raise ValueError(f'msgpack ext type {code} is not an array')
        shape, dtype, buffer = msgpack.unpackb(payload, raw=True)
        array = np.frombuffer(buffer, dtype=np.dtype(dtype.decode())) \
            .reshape(shape)
        return array if code == 1 else array[()]

    return msgpack.unpackb(data, ext_hook=ext_hook, raw=False,
                           strict_map_key=False)


def read_params_file(path) -> dict:
    """The port's ``state_dict`` from a checkpoint or a weights-only file,
    of the port (``torch.save``) or of the JAX package (msgpack, converted
    with ``flax_to_torch``).  A full checkpoint's ``model`` entry is taken,
    as the reference does (DummyNet/of.py:41-44)."""
    jax_file = file_format(path) == 'msgpack'
    state = (_decode_msgpack(Path(path).read_bytes()) if jax_file
             else load_state_file(path))
    if isinstance(state, dict) and 'model' in state:
        state = state['model']
    return flax_to_torch(state) if jax_file else state


def find_ema_params(opt_state_dict):
    """The ``ema_params`` entry of a saved ``Optimizer.state_dict()``, or
    None."""
    if not isinstance(opt_state_dict, dict):
        return None
    return opt_state_dict.get('ema_params')


class Serializer:
    def __init__(self,
                 path,
                 keep_checkpoints_max=math.inf,
                 permanent_checkpoint_interval=1,
                 name_template='step_{}.ckpt',
                 async_write=False):
        """
        Args:
            async_write: copy the state to the host at the call, and write
                the file in a background thread (``wait`` joins it), so
                training goes on while the file is written.
        """
        self._path = Path(path)
        self._path.mkdir(parents=True, exist_ok=True)
        self._history_size = keep_checkpoints_max
        self._permanent_interval = permanent_checkpoint_interval
        self._permanent_checkpoints = dict()
        self._temporal_checkpoints = dict()
        self._async_write = async_write
        self._pending = None
        if parse_template(name_template,
                          name_template.format(0)) is None:
            raise ValueError('the checkpoint name template must have '
                             'exactly one field')
        self._name_template = name_template
        self._find_checkpoints()

    def _remove_old(self):
        if self._history_size <= 0 or not math.isfinite(self._history_size):
            return
        temporal_steps = sorted(self._temporal_checkpoints, reverse=True)
        for step in temporal_steps[int(self._history_size):]:
            (self._path / self._temporal_checkpoints.pop(step)).unlink()
            logging.info(f'Checkpoint with ID={step} is removed')

    def _find_checkpoints(self):
        known = {}
        for entry in self._path.iterdir():
            step = parse_template(self._name_template, entry.name)
            if step is not None and step[0].isdigit():
                known[int(step[0])] = entry.name
        if self._permanent_interval > 0:
            self._permanent_checkpoints = {
                s: n for s, n in known.items()
                if s % self._permanent_interval == 0}
        self._temporal_checkpoints = {
            s: n for s, n in known.items()
            if s not in self._permanent_checkpoints}

    def _id2path(self, global_step):
        return self._path / self._name_template.format(global_step)

    def checkpoint_model(self, model_state, opt_state, global_step,
                         **kwargs):
        """Persist the model's and the optimizer's ``state_dict`` and the
        step (plus extras such as ``samples_passed``) for resuming."""
        # the previous write's thread also prunes the step dicts
        self.wait()
        path = self._id2path(global_step)
        if (self._permanent_interval > 0
                and global_step % self._permanent_interval == 0):
            self._permanent_checkpoints[global_step] = path.name
        else:
            self._temporal_checkpoints[global_step] = path.name
        state = {'model': model_state, 'optimizer': opt_state,
                 'global_step': global_step}
        state.update(kwargs)
        if not self._async_write:
            save_state_file(path, state)
            self._remove_old()
            return
        state = to_host(state)     # synchronous: the live state moves on
        failure = []

        def write():
            try:
                _write(path, state)
                self._remove_old()
            except BaseException as exc:   # re-raised by wait()
                failure.append(exc)

        thread = threading.Thread(target=write, daemon=True)
        self._pending = (thread, failure)
        thread.start()

    def wait(self):
        """Block until a pending background write completes; raises the
        write's error, if it failed."""
        if self._pending is None:
            return
        thread, failure = self._pending
        thread.join()
        self._pending = None
        if failure:
            raise failure[0]

    def has_checkpoints(self):
        return (len(self._temporal_checkpoints)
                + len(self._permanent_checkpoints)) > 0

    def list_known_steps(self):
        return sorted(list(self._temporal_checkpoints)
                      + list(self._permanent_checkpoints))

    def read_state_dict(self, global_step: int):
        return load_state_file(self._id2path(global_step))

    def finalize(self,
                 global_step: int,
                 path: typing.Union[str, os.PathLike],
                 use_ema: bool = False):
        """Export a weights-only file ``{'model': state_dict}``.

        ``use_ema=True`` exports the parameter EMA (``--ema-decay``) in
        place of the live weights; raises if the checkpoint holds none.
        """
        state = self.read_state_dict(global_step)
        model = state['model']
        if use_ema:
            model = find_ema_params(state.get('optimizer'))
            if model is None:
                raise ValueError(
                    f'checkpoint step {global_step} holds no parameter '
                    'EMA (train with --ema-decay to record one)')
        _write(path, {'model': model})

    def load_checkpoint(self, global_step, model=None, optimizer=None):
        """Load a checkpoint; returns ``(global_step, model_state,
        opt_state, extra_state)``.  A ``model`` or ``optimizer`` given
        takes its state in place, exactly: the model also the buffers
        that ``state_dict()`` leaves out, where the checkpoint holds
        them (``buffers``, ``hooks.SerializationHook``)."""
        if (global_step not in self._temporal_checkpoints
                and global_step not in self._permanent_checkpoints):
            raise ValueError(f'Checkpoint for step {global_step} not found')
        state = self.read_state_dict(global_step)
        step = int(state.pop('global_step'))
        model_state = state.pop('model')
        opt_state = state.pop('optimizer', None)
        buffers = state.pop('buffers', {})
        if model is not None:
            model.load_state_dict(model_state, strict=True)
            live = dict(model.named_buffers())
            with torch.no_grad():
                for name, value in buffers.items():
                    live[name].copy_(value)
        if optimizer is not None:
            optimizer.load_state_dict(opt_state)
        return step, model_state, opt_state, state
