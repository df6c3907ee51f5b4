"""Inference wrapper: flow for windows of raw events.

Counterpart of ``BaseOpticalFlow`` of
``dvs_of_training_framework_tpu/models/optical_flow.py`` (reference
DummyNet/of.py:18-125); each plugin module of the port
(``models/{evflownet,recurrent_flownet,dummy_flownet}.py``) subclasses it
as its ``OpticalFlow``, as the JAX plugins do.  It collates raw event
windows into one padded batch, with the same capacity buckets
(``default_buckets`` from 4096 up to ``event_capacity``) and the same
time normalisation (each call's timestamps relative to its earliest),
runs the network under ``torch.inference_mode()`` on the model's device,
so that K1 and K2 run their forward kernels on a card, and returns NHWC
numpy flow.  The JAX
wrapper's 8-byte wire records (``pack_events_wire``) are a TPU upload
codec and are left out: the flow is the same without them.

Weights come from ``model``, a checkpoint or weights-only file of the port
or of the JAX package (``training.serializer.read_params_file``), or, when
it names no file, from the model's own seeded initialisation.  The device
defaults to ``cuda``; a CPU wrapper runs the kernels' plain twins.
"""
from pathlib import Path

import numpy as np
import torch

from ..data.schema import default_buckets, pad_events, round_up_to_bucket
from .loader import filter_kwargs


class BaseOpticalFlow:
    """Compute optical flow for windows of raw events.

    Args:
        imsize: (height, width) of the produced flow.
        model_cls: the plugin's model class.
        model: path to a parameters/checkpoint file (or None for the
            seeded fresh initialisation).
        activation: activation name forwarded to the model.
        event_capacity: maximum events per call (bucketed below this).
        device: where the network runs.
        model_kwargs: extra model construction kwargs.
    """

    def __init__(self,
                 imsize,
                 model_cls,
                 model=None,
                 activation='relu',
                 event_capacity=2 ** 19,
                 device='cuda',
                 **model_kwargs):
        self.imsize = tuple(int(v) for v in imsize)
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'device {device}: no CUDA device is '
                               'available')
        kwargs = filter_kwargs(model_cls, dict(model_kwargs,
                                               activation=activation))
        self._net = model_cls(generator=torch.Generator().manual_seed(0),
                              device=self.device, **kwargs)
        self._net.eval()
        self._buckets = default_buckets(event_capacity)
        if model is not None and Path(str(model)).is_file():
            from ..training.serializer import read_params_file
            self.load_state_dict(read_params_file(model))

    def load_state_dict(self, params):
        self._net.load_state_dict(params, strict=True)

    def _collate(self, events, start, stop):
        rows = []
        sample_index = []
        for i, e in enumerate(events):
            e = np.asarray(e, dtype=np.float64)
            rows.append(e)
            sample_index.append(np.full(e.shape[1], i))
        flat = np.hstack(rows) if rows else np.zeros((4, 0))
        sample_index = (np.hstack(sample_index) if sample_index
                        else np.zeros(0))
        timestamps = np.hstack([[b, e] for b, e in zip(start, stop)])
        sample_idx = np.hstack([[i, i] for i in range(len(start))])
        min_t = timestamps.min()
        ev = {'x': flat[0], 'y': flat[1],
              'timestamp': flat[2] - min_t,
              'polarity': flat[3],
              'element_index': np.zeros_like(sample_index),
              'sample_index': sample_index}
        capacity = round_up_to_bucket(flat.shape[1], self._buckets)
        buf = pad_events(ev, batch_size=len(start), capacity=capacity)
        return buf, (timestamps - min_t).astype(np.float32), \
            sample_idx.astype(np.int32)

    def __call__(self, events, start, stop, return_all=False):
        """Predict flow.

        Args:
            events: list of per-window ``(x, y, t, p)`` column stacks
                (``[4, N]`` arrays or 4-tuples of arrays); polarity ±1.
            start, stop: per-window timestamps.
            return_all: return predictions at every scale.

        Returns:
            ``[B, H, W, 2]`` numpy flow (finest scale), or a tuple per scale.
        """
        ev, timestamps, sample_idx = self._collate(events, start, stop)
        with torch.inference_mode():
            flows = self._net(ev.to(self.device),
                              torch.from_numpy(timestamps).to(self.device),
                              torch.from_numpy(sample_idx).to(self.device),
                              self.imsize)[0]
        return self._postprocess(flows, return_all)

    @staticmethod
    def _postprocess(flow, return_all):
        def back(f):
            return np.transpose(f.float().cpu().numpy(), (0, 2, 3, 1))
        if return_all:
            return tuple(map(back, flow))
        return back(flow[-1])

