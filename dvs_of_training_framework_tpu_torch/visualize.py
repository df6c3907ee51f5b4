#!/usr/bin/env python3
"""Qualitative inspection CLI of the port: a panel of flow predictions for
every validation batch.

Counterpart of the repo's root ``visualize.py``, function by function.
For each batch of the validation split (one sample a batch) it runs the
plugin's model forward (``--flownet_path``, ``--precision``; on the card
the K1 and K2 forward kernels) and the multi-scale loss at the 'highest'
loss precision (the ``F.grid_sample`` warp), then draws one panel: a
caption banner with the loss terms and the events' split into prefix,
predicted and suffix elements, the input frames, and the HSV rendering
of every prediction at every scale (finest on top, the coarser ones in a
strip below), offset by the prefix length.  Writer processes store each
panel and its statistics.

    python -m dvs_of_training_framework_tpu_torch.visualize -m RUN \
        [-sp CHECKPOINT] [--flownet_path EVFlowNet] [-d cuda] [options]

The options are the training CLI's; the split is ``outdoor_day1`` under
``$DVS_DATA_PATH``.  Output goes to ``<repo>/visualization/<name of
-m>/<stem of -sp, or step_0>/<i:04d>.png`` and ``.yml``; a batch whose
two files exist is skipped, so a rerun resumes, and a batch over
``--event-capacity`` events is skipped.  ``-sp`` takes a checkpoint of
the port or of the JAX package.  The device defaults to ``cuda``; ``-d
cuda`` without a card raises.  Where the root CLI differs:

- the panels are PNGs of ``utils/visualization.write_png`` (zlib, no
  Pillow), and the caption is drawn in that module's fixed bitmap font,
  not in Pillow's default one: the banner's text is the root CLI's,
  its pixels the port's own;
- the statistics file keeps the ``.yml`` name and holds JSON, which
  YAML readers read (the convention of the port's provenance files);
- the writers are spawned processes, not forked ones, so that they may
  start after CUDA is initialised (the root CLI starts its pool first
  for that reason); one that fails makes ``main`` raise;
- fp32 convolutions and matmuls run without TF32, as the JAX package's
  'highest'.
"""
import json
import multiprocessing
import sys
from argparse import ArgumentParser
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from .data import pad_batch
from .data.dataloader import (choose_data_path, get_dataloader,
                              get_valset_params)
from .losses import LOSS_PRECISIONS, MultiScaleLoss, combined_loss
from .models.loader import init_model, load_vis_flow
from .train import flow_shapes, pad_sequence_length, resolve_device
from .utils.common import mean
from .utils.options import add_train_arguments, validate_train_args
from .utils.progress import progress
from .utils.visualization import draw_text, write_png

REPO = Path(__file__).resolve().parents[1]
BANNER_ROWS = 80


def parse_args(argv):
    parser = add_train_arguments(ArgumentParser())
    parser.set_defaults(device='cuda')
    args = validate_train_args(parser.parse_args(argv))
    return choose_data_path(args)


# --- statistics & caption -----------------------------------------------------

def count_context_events(args, batch):
    """(prefix, main, suffix) event counts of the batch."""
    element = batch['events']['element_index']
    seq_length = int(batch['augmentation_params']['sequence_length'][0])
    n_prefix = int((element < args.prefix_length).sum())
    n_suffix = int((element >= seq_length - args.suffix_length).sum())
    return n_prefix, element.size - n_prefix - n_suffix, n_suffix


def _share(n, total):
    return f'{n} ({n * 100 / total:.2f}%)'


def prepare_text(args, batch, loss, parts, weights):
    """Panel caption + statistics for one batch.

    ``parts`` are the per-scale (smoothness, photometric, border) loss terms.
    """
    parts = [list(map(float, term)) for term in parts]
    n_prefix, n_main, n_suffix = count_context_events(args, batch)
    statistics = {'loss': float(loss),
                  'smoothness': parts[0],
                  'photometric': parts[1],
                  'border': parts[2],
                  'prefix_size': n_prefix,
                  'pred_size': n_main,
                  'suffix_size': n_suffix}

    weighted = ' + '.join(f'{w}*{mean(term):.4f}'
                          for term, w in zip(parts, weights))
    per_scale = '\n'.join(
        f'{name}: {mean(term):.4f} = '
        f'[{", ".join(f"{x:.4f}" for x in term)}]'
        for name, term in zip(('smoothness', 'photometric', 'border'),
                              parts))
    total = max(n_prefix + n_main + n_suffix, 1)
    caption = (f'loss: {float(loss):.4f} = {weighted}\n'
               f'{per_scale}\n'
               f'{total} events: {_share(n_prefix, total)} prefix '
               f'+ {_share(n_main, total)} main + '
               f'{_share(n_suffix, total)}')
    return caption, statistics


# --- panel assembly -----------------------------------------------------------

def _blit(canvas, tile, x, y):
    h, w = tile.shape[:2]
    canvas[y:y + h, x:x + w] = tile


def join_images(images):
    """Input frames side by side as one RGB strip."""
    images = np.asarray(images).astype(np.uint8)
    assert images.ndim == 4
    strip = np.hstack(np.transpose(images, (0, 2, 3, 1)))
    if strip.shape[-1] == 1:
        strip = np.tile(strip, (1, 1, 3))
    return strip


def visualize_prediction(prediction, vis_flow):
    """One prediction as a panel: finest scale on top, the coarser scales
    left-aligned in a strip below it."""
    rendered = [vis_flow(np.transpose(np.asarray(flow), (1, 2, 0)))
                for flow in prediction]
    finest, coarser = rendered[-1], rendered[-2::-1]
    strip_h = coarser[0].shape[0] if coarser else 0
    canvas = np.zeros((finest.shape[0] + strip_h, finest.shape[1],
                       finest.shape[2]), dtype=np.uint8)
    _blit(canvas, finest, 0, 0)
    x = 0
    for tile in coarser:
        _blit(canvas, tile, x, finest.shape[0])
        x += tile.shape[1]
    return canvas


def visualize_predictions(args, batch, predictions, vis_flow):
    """All predictions side by side, offset by the prefix context."""
    flows_per_scale = predictions['prediction']
    n_predictions = flows_per_scale[-1].shape[0]
    panels = [visualize_prediction([scale[i] for scale in flows_per_scale],
                                   vis_flow)
              for i in range(n_predictions)]
    row = np.concatenate(panels, axis=1)
    panel_h, panel_w = panels[0].shape[:2]
    seq_length = int(batch['augmentation_params']['sequence_length'][0])
    canvas = np.zeros((panel_h, panel_w * (seq_length + 1), 3),
                      dtype=np.uint8)
    _blit(canvas, row, args.prefix_length * panel_w + panel_w // 2, 0)
    return canvas


def visualize(args, batch, loss, parts, weights, prediction, vis_flow):
    """Full panel (BGR): caption banner, input frames, flow renderings."""
    frames = join_images(batch['images'])
    caption, statistics = prepare_text(args, batch, loss, parts, weights)
    banner = draw_text(np.zeros((BANNER_ROWS, frames.shape[1], 3),
                                np.uint8), caption)
    flow_row = visualize_predictions(args, batch, prediction, vis_flow)
    panel = np.concatenate([banner, frames, flow_row], axis=0)
    return panel, statistics


def visualize_batch(args, model, evaluator, batch, device, vis_flow,
                    seconds=None):
    """One host batch end to end: its forward with the intermediate
    features and its loss on ``device``, then its panel.  Returns
    ``(panel, statistics, prediction)``, the prediction's flows float32
    numpy arrays.  ``seconds``, where given, gains the time on the device
    (the batch's upload, the forward, the loss and the fetch of their
    results) under ``'device'`` and the rendering's under ``'render'``."""
    t0 = perf_counter()
    device_batch = pad_batch(
        batch, capacity=args.event_capacity,
        sequence_length=pad_sequence_length(args)).to(device)
    with torch.inference_mode():
        flows, flow_ts, flow_sample_idx, _ = model(
            device_batch.events, device_batch.timestamps,
            device_batch.sample_idx, tuple(device_batch.images.shape[-2:]),
            intermediate=True)
        loss, terms = combined_loss(
            evaluator, flows, flow_ts, flow_sample_idx, device_batch.images,
            device_batch.timestamps, device_batch.sample_idx,
            weights=tuple(args.loss_weights))
        values = torch.stack([loss.float()] + [v.float() for term in terms
                                                for v in term]).cpu()
    prediction = {'prediction': [f.float().cpu().numpy() for f in flows],
                  'flow_ts': flow_ts.cpu().numpy(),
                  'flow_sample_idx': flow_sample_idx.cpu().numpy()}
    values = values.tolist()
    n = len(terms[0])
    parts = [values[1 + i * n:1 + (i + 1) * n] for i in range(len(terms))]
    t1 = perf_counter()
    panel, statistics = visualize(args, batch, values[0], parts,
                                  args.loss_weights, prediction, vis_flow)
    if seconds is not None:
        seconds['device'] += t1 - t0
        seconds['render'] += perf_counter() - t1
    return panel, statistics, prediction


# --- output -------------------------------------------------------------------

def files(stem):
    """(png, yml) output paths for a panel stem."""
    return stem.parent / f'{stem.name}.png', stem.parent / f'{stem.name}.yml'


def choose_output_path(args):
    leaf = 'step_0' if args.sp is None else Path(args.sp).stem
    out = REPO / 'visualization' / args.model.name / leaf
    out.mkdir(parents=True, exist_ok=True)
    return out


def image_writer(image_queue):
    """Writer-process loop: drain panels until the None sentinel."""
    for stem, panel, statistics in iter(image_queue.get, None):
        png, yml = files(stem)
        if not png.is_file():
            write_png(png, panel[..., ::-1])  # BGR -> RGB
        if not yml.is_file():
            yml.write_text(json.dumps(statistics, indent=2, sort_keys=True))


class PanelWriterPool:
    """Spawned processes draining a panel queue (PNG encode off the main
    loop)."""

    def __init__(self, num_writers=None):
        context = multiprocessing.get_context('spawn')
        self.queue = context.Queue()
        self._writers = [
            context.Process(target=image_writer, args=(self.queue,),
                            daemon=True)
            for _ in range(num_writers or multiprocessing.cpu_count())]
        for writer in self._writers:
            writer.start()

    def submit(self, stem, panel, statistics):
        self.queue.put((stem, panel, statistics))

    def close(self):
        """Send every writer its sentinel and wait for all; raises if one
        failed (its panels may be missing)."""
        for _ in self._writers:
            self.queue.put(None)
        for writer in self._writers:
            writer.join()
        failed = [w.exitcode for w in self._writers if w.exitcode]
        if failed:
            self.queue.cancel_join_thread()   # no reader is left
            raise RuntimeError(f'panel writers exited with {failed}')


def main(argv=None, num_writers=None):
    """Render the panels as the arguments say, with ``num_writers``
    writer processes (default: one a CPU core).  Returns ``{'panels':
    written, 'existing': skipped as done, 'oversized': skipped over
    capacity, 'seconds': {'read', 'device', 'render', 'write'}}``: the
    time spent waiting for the loader, on the device, rendering, and
    handing panels to the writers and waiting for them to finish."""
    writers = PanelWriterPool(num_writers)
    try:
        args = parse_args(sys.argv[1:] if argv is None else argv)
        args.mbs = 1
        device = resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        output_dir = choose_output_path(args)
        model = init_model(args, device)
        vis_flow = load_vis_flow(args.flownet_path)
        loader = get_dataloader(get_valset_params(args))
        evaluator = MultiScaleLoss(flow_shapes(args.shape),
                                   bf16x2=LOSS_PRECISIONS['highest'])
        record = {'panels': 0, 'existing': 0, 'oversized': 0,
                  'seconds': dict.fromkeys(('read', 'device', 'render',
                                            'write'), 0.0)}
        seconds = record['seconds']
        try:
            total = len(loader)
        except TypeError:
            total = None
        t = perf_counter()
        for i, batch in enumerate(progress(loader, total=total)):
            seconds['read'] += perf_counter() - t
            stem = output_dir / f'{i:04d}'
            if all(path.is_file() for path in files(stem)):
                record['existing'] += 1
            elif batch['events']['x'].size > args.event_capacity:
                record['oversized'] += 1
            else:
                panel, statistics, _ = visualize_batch(
                    args, model, evaluator, batch, device, vis_flow,
                    seconds)
                t = perf_counter()
                writers.submit(stem, panel, statistics)
                seconds['write'] += perf_counter() - t
                record['panels'] += 1
            t = perf_counter()
    finally:
        t = perf_counter()
        writers.close()
    seconds['write'] += perf_counter() - t
    print(f'{record["panels"]} panels written to {output_dir} '
          f'({record["existing"]} done before, {record["oversized"]} over '
          f'--event-capacity {args.event_capacity})')
    return record


if __name__ == '__main__':
    main()
