#!/usr/bin/env python3
"""Checkpoint benchmarking CLI of the port: AEE on MVSEC-format sequences.

Counterpart of the repo's root ``test.py`` on one device: it evaluates
one checkpoint (``-s``) or every known checkpoint of a run directory
against a test matrix (``--test-config``, JSON or YAML; default the
package's ``config/testing.json``, the JSON twin of ``config/testing.yml``,
so that no PyYAML is needed), writes one pickle of per-configuration
results a checkpoint (``step_<n>.pkl``, ``step_<n>_ema.pkl`` with ``--use-ema``),
each with its mean AEE, %AEE<3px, mean median EE and per-window records,
and aggregates the results to TensorBoard keyed by samples passed.  The
data roots come from ``$DVS_DATA_ROOT`` (``raw/`` and ``info/``), which
must be set (the root CLI also falls back to a ``data/`` directory beside
the checkout), and every file is read through ``data/store.py``
(the npy store, or HDF5 read with h5py).

    python -m dvs_of_training_framework_tpu_torch.test -m RUN -o OUT \
        [-s STEP] [--use-ema] [--test-config CONFIG] [-d cuda] \
        [--tests_per_device N]

Every checkpoint of a run is scored through ``DevicePool``, the root
CLI's scheduler (the reference's ``GPUPool``): a thread pool that puts
each job on the device with the fewest outstanding jobs, at most
``--tests_per_device`` (2 by default) on a device at once.  ``-d cuda``
spreads the checkpoints over every visible card, ``-d cuda:i`` keeps them
on that card, ``-d cpu`` on the CPU; a job on a card runs under that
card and on a CUDA stream of its own, so that two jobs on one card
overlap.  The kernels are built and loaded once before the jobs start,
and the test matrix is loaded once and shared by every job.  ``-d
cuda`` without a card raises.  Convolutions and matmuls run in full
fp32 (TF32 off), as the JAX package's 'highest', and cuDNN takes its
deterministic algorithms, so that a checkpoint's pickle does not depend
on which card or job scored it.  The plugin's ``OpticalFlow`` comes
through the port's loader
(``--flownet_path``, ``models/loader.py``).  Evaluation windows hold one
element each, so ``--max-sequence-length`` above 1 and context elements
(``--prefix-length``, ``--suffix-length``) are refused (the root CLI
would fail inside the model): a recurrent plugin's wrapper takes one
element, a single ConvGRU step.
"""
import contextlib
import pickle
import re
import sys
import tempfile
import threading
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .data import store
from .evaluation import evaluate, ravel_config, read_config
from .models.loader import filter_kwargs, load_plugin
from .train import resolve_device
from .training.serializer import Serializer
from .utils.common import data_root
from .utils.options import (add_test_arguments, options2model_kwargs,
                            validate_test_args)
from .utils.tb import SummaryWriter

CONFIG = Path(__file__).resolve().parent / 'config'


def parse_args(argv=None):
    parser = ArgumentParser()
    add_test_arguments(parser)
    parser.set_defaults(device='cuda')
    args = validate_test_args(parser.parse_args(argv))
    if (args.max_sequence_length, args.prefix_length,
            args.suffix_length) != (1, 0, 0):
        raise ValueError('--max-sequence-length, --prefix-length, '
                         '--suffix-length: evaluation windows hold one '
                         'element each')
    if args.tests_per_device < 1:
        raise ValueError('--tests_per_device must be 1 or more')
    return args


# --- sequence IO ------------------------------------------------------------

def seq2paths(dataset_path, seq_name):
    """Raw-data and GT file paths of an MVSEC sequence.

    ``outdoor_day2`` lives under ``<root>/outdoor_day/`` (the trailing
    digits name the take, the stem names the directory).
    """
    take_family = re.sub(r'\d+$', '', seq_name)
    return (dataset_path / take_family / f'{seq_name}_data.hdf5',
            dataset_path / 'FlowGT' / take_family /
            f'{seq_name}_gt_flow_dist.npz')


def load_events(path):
    """Events as 4 row-arrays [x, y, t, p] plus the frame timestamps."""
    with store.open_file(str(path), 'r') as f:
        davis = f['davis']['left']
        columns = np.asarray(davis['events'], dtype=np.float64)
        image_ts = np.asarray(davis['image_raw_ts'], dtype=np.float64)
    return columns.T, image_ts


def load_gt(path):
    with np.load(str(path)) as archive:
        return dict(archive)


def load_sequence(dataset_path, seq_name, first_ts):
    """Assemble the per-sequence record consumed by perform_single_test."""
    seq_file, gt_file = seq2paths(dataset_path, seq_name)
    record = SimpleNamespace(name=seq_name, first_ts=first_ts)
    record.events, record.image_ts = load_events(seq_file)
    record.gt = load_gt(gt_file)
    record.imshape = record.gt['x_flow_dist'].shape[1:]
    return record


# --- one (checkpoint, sequence, config) evaluation ---------------------------

def resolve_time_range(cfg, dataset):
    """Make cfg.start/stop absolute; defaults span the whole sequence."""
    first = dataset.first_ts
    cfg.start = first if cfg.start is None else first + cfg.start
    if cfg.stop is None:
        cfg.stop = min(dataset.events[2][-1], dataset.gt['timestamps'][-2])
    else:
        cfg.stop = first + cfg.stop
    return cfg


def generate_frames(cfg, image_ts):
    """(start, stop) frame-timestamp windows, ``cfg.step`` frames apart."""
    lo, hi = np.searchsorted(image_ts, [cfg.start, cfg.stop])
    starts = image_ts[lo:hi - cfg.step]
    stops = image_ts[lo + cfg.step:hi]
    return list(zip(starts, stops))


def build_crops(imshape, test_shape, crop_type):
    """(event_crop, image_crop) pair for the configured crop type."""
    from .data.augmentation import EventCrop, ImageCrop, central_shift
    if crop_type != 'central':
        raise ValueError(f'Unknown crop type "{crop_type}"')
    box = [*central_shift(imshape, test_shape), *test_shape]
    return EventCrop(box), ImageCrop(box)


def init_model(args, test_shape):
    """The plugin's OpticalFlow wrapper on ``args.device`` (the root
    CLI's ``init_model``, through the port's loader)."""
    module = load_plugin(args.flownet_path)
    kwargs = filter_kwargs(module.OpticalFlow, options2model_kwargs(args))
    if args.model is not None:
        kwargs['model'] = args.model
    return module.OpticalFlow(test_shape,
                              device=getattr(args, 'device', 'cuda'),
                              **kwargs)


def perform_single_test(args, cfg, dataset):
    cfg = resolve_time_range(cfg, dataset)
    event_crop, gt_crop = build_crops(dataset.imshape, cfg.test_shape,
                                      cfg.crop_type)
    stats = {}
    maee, mpaee = evaluate(
        init_model(args, cfg.test_shape),
        dataset.events,
        generate_frames(cfg, dataset.image_ts),
        dataset.gt,
        event_preproc_fun=event_crop,
        pred_postproc_fun=None,
        gt_proc_fun=gt_crop,
        is_car=cfg.is_car,
        log=False,
        batch_windows=getattr(args, 'eval_batch_windows', 8),
        stats_out=stats)
    return maee, mpaee, stats


# --- per-checkpoint evaluation -----------------------------------------------

def get_output_path(args):
    if Path(args.model).suffix == '.ckpt':
        checkpoint = Path(args.model)
    else:
        checkpoint = Serializer(args.model)._id2path(args.step)
    suffix = '_ema' if getattr(args, 'use_ema', False) else ''
    return args.output / (checkpoint.stem + suffix + '.pkl')


def export_weights_only(args):
    """Stage a weights-only temp checkpoint for the requested step.

    Works on a COPY of ``args``: process_all re-reads ``args.model`` (the
    original run directory) after the job to aggregate samples_passed, so
    the temp-checkpoint path must not leak back into the caller's
    namespace.
    """
    args = SimpleNamespace(**vars(args))
    args.output = get_output_path(args)
    args.is_temporary_model = True
    handle = tempfile.NamedTemporaryFile(suffix='.ckpt', delete=False)
    handle.close()
    Serializer(args.model).finalize(args.step, handle.name,
                                    use_ema=getattr(args, 'use_ema',
                                                    False))
    args.model = Path(handle.name)
    return args


def iterate_test_matrix(config, data_dir, info_dir):
    """Yield (sequence record, raveled config) pairs for the whole matrix."""
    from .data.dataset import read_info
    for ds_name, ds_config in config.items():
        info = read_info(str(info_dir / f'{ds_name}.hdf5'))
        for seq_name, seq_config in ds_config.items():
            dataset = load_sequence(data_dir / ds_name, seq_name,
                                    info[seq_name])
            for cfg in ravel_config(seq_config):
                cfg.dataset = ds_name
                cfg.sequence = seq_name
                yield dataset, cfg


def build_test_matrix(args=None):
    """Materialise the whole test matrix (each sequence loaded ONCE).

    The returned list is read-only shared across checkpoint jobs —
    per-checkpoint state (resolved time ranges, results) lives on copies.
    """
    root = data_root('DVS_DATA_ROOT')
    config_path = getattr(args, 'test_config', None) \
        or CONFIG / 'testing.json'
    config = read_config(config_path)
    return list(iterate_test_matrix(config, root / 'raw', root / 'info'))


def process_single(args, matrix=None):
    args = export_weights_only(args)
    if args.output.is_file():  # this checkpoint was already evaluated
        if args.is_temporary_model:
            args.model.unlink()
        return

    if matrix is None:
        matrix = build_test_matrix(args)

    results = []
    for dataset, shared_cfg in matrix:
        cfg = SimpleNamespace(**vars(shared_cfg))  # job-local copy
        cfg.mAEE, cfg.mpAEE, stats = perform_single_test(args, cfg,
                                                         dataset)
        # the robust statistic and the per-window records: a few hard
        # windows can spike the mean AEE while the typical pixel improves
        cfg.mMedEE = stats.get('median_ee')
        cfg.windows = stats.get('windows')
        results.append(cfg)
        print(f'[{cfg.sequence}, {cfg.start}, {cfg.stop}, '
              f'{cfg.step}, {cfg.test_shape}, {cfg.crop_type}, '
              f'{cfg.is_car}]: Mean AEE: {cfg.mAEE:.6f}, '
              f'mean %AEE: {cfg.mpAEE * 100:.6f}, '
              f'mean median-EE: {cfg.mMedEE:.6f}')
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_bytes(pickle.dumps(results))
    if args.is_temporary_model:
        args.model.unlink()


def get_samples_passed(args):
    state = Serializer(args.model).read_state_dict(args.step)
    fallback = int(state['global_step']) * args.bs
    return int(state.get('samples_passed', fallback))


def pool_devices(name):
    """The devices that ``-d name`` gives the pool: every visible card
    for ``cuda``, the one card of ``cuda:i``, one CPU device for
    ``cpu``."""
    device = resolve_device(name)
    if device.type == 'cuda' and device.index is None:
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [device]


@contextlib.contextmanager
def on_device(device):
    """Run a job's work on ``device``: a card's as the thread's current
    device, on a stream of its own, which is synchronized at the end."""
    if device.type != 'cuda':
        yield
        return
    stream = torch.cuda.Stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield
    stream.synchronize()


class DevicePool:
    """Least-loaded scheduler of evaluation jobs across local devices.

    The root CLI's ``DevicePool`` (the reference's ``GPUPool``): one
    thread pool, each job on the device with the fewest outstanding
    jobs, at most ``tests_per_device`` concurrent jobs a device.  A job
    is ``func(job_args, device)`` and runs inside ``on_device(device)``;
    the first job's exception, in submission order, is raised by the
    call, once the jobs already running have ended.  Threads, as in the
    JAX package: the model's work releases the GIL, the GT propagation's
    NumPy mostly holds it.
    """

    def __init__(self, devices, tests_per_device=2):
        self._devices = [torch.device(d) for d in devices]
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, len(self._devices) * tests_per_device))
        self._lock = threading.Lock()
        self._load = {i: 0 for i in range(len(self._devices))}

    def _acquire(self):
        with self._lock:
            idx = min(self._load, key=self._load.get)
            self._load[idx] += 1
            return idx

    def _release(self, idx):
        with self._lock:
            self._load[idx] -= 1

    def __call__(self, func, args_list):
        def run(job_args):
            idx = self._acquire()
            try:
                with on_device(self._devices[idx]):
                    return func(job_args, self._devices[idx])
            finally:
                self._release(idx)

        try:
            futures = [self._pool.submit(run, a) for a in args_list]
            for f in futures:
                f.result()
        finally:
            self._pool.shutdown(cancel_futures=True)


def process_all(args, devices=None):
    """Score every checkpoint of ``args.model`` through ``DevicePool`` on
    ``devices`` (``pool_devices(args.device)`` by default), then write
    the TensorBoard scalars of every pickle."""
    args.__dict__.pop('step', None)
    per_step = [SimpleNamespace(step=s, **args.__dict__)
                for s in Serializer(args.model).list_known_steps()]
    devices = pool_devices(args.device) if devices is None else devices
    if any(torch.device(d).type == 'cuda' for d in devices):
        from .ops import _build
        _build.library()    # built and loaded once, before the jobs
    # sequences are loaded once and shared read-only by every checkpoint
    matrix = build_test_matrix(args)

    def job(step_args, device):
        # a copy of the job's arguments on its device (init_model)
        process_single(SimpleNamespace(**dict(vars(step_args),
                                              device=str(device))), matrix)

    DevicePool(devices, args.tests_per_device)(job, per_step)

    writer = SummaryWriter(args.output / 'log')
    for step_args in per_step:
        samples_passed = get_samples_passed(step_args)
        results = pickle.loads(get_output_path(step_args).read_bytes())
        for r in results:
            tag = (f'{r.dataset}/{r.sequence}/{r.step}/'
                   f'{r.start}/{r.stop}')
            writer.add_scalar(f'Test/mean AEE/{tag}', r.mAEE,
                              samples_passed)
            writer.add_scalar(f'Test/mean %AEE/{tag}', r.mpAEE * 100,
                              samples_passed)
    writer.close()


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if args.step is None:
        process_all(args)
    else:
        process_single(args)


if __name__ == '__main__':
    main()
