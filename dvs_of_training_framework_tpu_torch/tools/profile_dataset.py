#!/usr/bin/env python3
"""Measure the training loader's iteration latency (µs/iteration).

The port's entry point after ``scripts/profile_dataset.py`` (reference
scripts/profile_dataset.py + utils/performance.py), over the port's
loader and ``utils/performance.get_iterable_performance``: raw elements
under ``$DVS_DATA_PATH`` (which must be set), or shards with
``--preprocessed-dataset-path``.

Usage:
    DVS_DATA_PATH=<split root> python -m \
        dvs_of_training_framework_tpu_torch.tools.profile_dataset \
        [--start 100] [--num-iters 500] [dataset and loader options]
"""
from argparse import ArgumentParser
import sys

from ..data.dataloader import (choose_data_path, get_dataloader,
                               get_trainset_params)
from ..utils.options import (add_dataloader_arguments, add_dataset_arguments,
                             add_preprocessed_dataset_arguments,
                             validate_dataset_args)
from ..utils.performance import get_iterable_performance


def parse_args(args):
    parser = ArgumentParser()
    parser = add_dataset_arguments(parser)
    parser = add_dataloader_arguments(parser)
    parser = add_preprocessed_dataset_arguments(parser)
    parser.add_argument('--start', type=int, default=100,
                        help='warmup iterations')
    parser.add_argument('--num-iters', type=int, default=500,
                        help='measured iterations')
    args = parser.parse_args(args)
    args = validate_dataset_args(args)
    args = choose_data_path(args)
    return args


def main(args):
    """Prints and returns the mean µs an iteration."""
    loader = get_dataloader(get_trainset_params(args))
    perf = get_iterable_performance(loader, start=args.start,
                                    num_iters=args.num_iters)
    print(f'{perf:.1f} us/iteration')
    return perf


if __name__ == '__main__':
    main(parse_args(sys.argv[1:]))
