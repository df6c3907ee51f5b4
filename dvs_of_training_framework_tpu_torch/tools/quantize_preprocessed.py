#!/usr/bin/env python3
"""Bake a trained model's learned event representation into dense shards.

The port's entry point after ``scripts/quantize_preprocessed.py``, with
the same arguments: it reads the raw training stream of a preprocessed
set (``--preprocessed-dataset-path``) at ``-mbs``, pads each batch to
``--event-capacity``, runs the ``--sp`` model's ``quantize`` on the
device under ``torch.inference_mode()``, copies the dense ``[B, L*C, H,
W]`` batch to the host once and writes it as encoded quantized shards
(the npy store, ``data/store.py``), which train with ``--ev_images``.
Bake at the training run's ``-mbs`` and ``--event-capacity``: a batch
with more events than the capacity is skipped and logged, as the
training loop would skip it.  The device defaults to ``cuda``; ``-d
cuda`` without a card raises.

Resumable: the ShardWriter counts the samples already on disk and the
run goes on until ``--size`` samples exist.  The stream is static, so
the batches skipped before that count are found again from the shards'
per-sample event counts, and the resumed stream starts past them: a
resumed bake writes what one run would have written.  (The JAX script
seeks by samples written alone, so after a skipped batch its resume
bakes some samples twice.)  As in the JAX script, a stream whose every
batch overflows the capacity skips forever.

Usage:
    DVS_DATA_PATH=<root>/training/synth python -m \
        dvs_of_training_framework_tpu_torch.tools.quantize_preprocessed \
        -o <baked> -s 16384 --samples-per-file 1024 -mbs 8 \
        --preprocessed-dataset-path <shards> --event-capacity 131072 \
        --precision bfloat16 -sp <run>/step_10000.ckpt
"""
import dataclasses
import sys
import time
from argparse import ArgumentParser

import torch

from ..data import codec
from ..data.dataloader import (choose_data_path, get_dataloader,
                               get_trainset_params)
from ..data.preprocessed import per_sample_event_counts, stream_position
from ..data.schema import pad_batch
from ..data.sharding import ShardWriter
from ..models import init_model
from ..train import resolve_device
from ..utils.common import (check_execution_info, collect_execution_info,
                            write_execution_info)
from ..utils.options import (add_common_arguments, add_dataloader_arguments,
                             add_dataset_arguments,
                             add_dataset_preprocessing_arguments,
                             add_model_arguments,
                             add_preprocessed_dataset_arguments,
                             add_tpu_arguments, resolve_event_capacity,
                             validate_dataset_args,
                             validate_quantization_args)
from ..utils.progress import progress


@dataclasses.dataclass
class BakeStats:
    """What one ``main`` did: batches baked and skipped, samples written,
    and its seconds in reading (the loader and padding), on the device
    (upload, ``quantize``, the copy back) and in writing (encoding and
    the shards)."""
    batches: int = 0
    skipped: int = 0
    samples: int = 0
    read_s: float = 0.0
    device_s: float = 0.0
    write_s: float = 0.0


def parse_args(args, is_write=True):
    parser = ArgumentParser()
    for extend in (add_common_arguments, add_dataset_arguments,
                   add_dataloader_arguments, add_model_arguments,
                   add_tpu_arguments, add_dataset_preprocessing_arguments,
                   add_preprocessed_dataset_arguments):
        parser = extend(parser)
    parser.set_defaults(device='cuda')
    args = validate_quantization_args(
        validate_dataset_args(parser.parse_args(args)))

    args.output.mkdir(exist_ok=True, parents=True)
    args = choose_data_path(args)
    # --event-capacity auto resolves before provenance is collected, so
    # the recorded (and resume-checked) value is the concrete buffer size
    resolve_event_capacity(args)

    execution_info = collect_execution_info(args)
    check_execution_info(args.output, execution_info, args)
    if is_write:
        write_execution_info(args.output, execution_info)
    return args


def quantize_batch(model, batch, device):
    """``model.quantize`` of one padded host batch on ``device``, back on
    the host as a float32 numpy array."""
    if device.type == 'cuda':
        batch = batch.pin_memory()
    batch = batch.to(device, non_blocking=True)
    with torch.inference_mode():
        dense = model.quantize(batch.events, batch.timestamps,
                               batch.sample_idx,
                               tuple(batch.images.shape[-2:]))
    return dense.cpu().numpy()


def main(args) -> BakeStats:
    device = resolve_device(args.device)
    model = init_model(args, device)
    args.output.mkdir(exist_ok=True)
    writer = ShardWriter(args.output, args.samples_per_file)
    start = writer.samples_written
    if start:
        start = stream_position(
            per_sample_event_counts(args.preprocessed_dataset_path),
            args.mbs, args.event_capacity, start)
    loader = get_dataloader(get_trainset_params(args), sample_idx=start)

    stats = BakeStats()
    bar = progress(initial=writer.samples_written, total=args.size,
                   unit='sample')
    batches = iter(loader)
    while writer.samples_written < args.size:
        t0 = time.perf_counter()
        batch = next(batches)
        num_events = batch['events']['x'].size
        if num_events > args.event_capacity:
            stats.skipped += 1
            stats.read_s += time.perf_counter() - t0
            print(f'Skipping batch with {num_events} events > capacity '
                  f'{args.event_capacity}')
            continue
        padded = pad_batch(batch, args.event_capacity)
        t1 = time.perf_counter()
        dense = quantize_batch(model, padded, device)
        t2 = time.perf_counter()
        before = writer.samples_written
        writer.add(codec.encode_quantized_batch(
            {'data': dense,
             'timestamps': batch['timestamps'],
             'sample_idx': batch['sample_idx'],
             'images': batch['images'],
             'augmentation_params': batch['augmentation_params'],
             'size': batch['size']}))
        t3 = time.perf_counter()
        stats.read_s += t1 - t0
        stats.device_s += t2 - t1
        stats.write_s += t3 - t2
        stats.batches += 1
        stats.samples += writer.samples_written - before
        bar.update(writer.samples_written - before)
    t0 = time.perf_counter()
    writer.flush()
    stats.write_s += time.perf_counter() - t0
    bar.close()
    print(f'Baked {stats.samples} samples in {stats.batches} batches '
          f'({stats.skipped} skipped): read {stats.read_s:.3f} s, device '
          f'{stats.device_s:.3f} s, write {stats.write_s:.3f} s')
    return stats


if __name__ == '__main__':
    main(parse_args(sys.argv[1:]))
