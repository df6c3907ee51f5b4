#!/usr/bin/env python3
"""Offline batch pre-augmentation: run the augmenting train loader and
shard encoded batches.

The port's entry point after ``scripts/prepare_batches.py``, with the
same arguments; its shards are the npy store (``data/store.py``), and its
provenance file is JSON.  Resumable: the ShardWriter counts samples
already on disk and the run continues until ``--size`` samples exist.

Usage:
    DVS_DATA_PATH=<root>/training/synth python -m \
        dvs_of_training_framework_tpu_torch.tools.prepare_batches \
        -o <shards> -s 16384 --samples-per-file 1024
"""
import sys
from argparse import ArgumentParser

from ..data import codec
from ..data.dataloader import (choose_data_path, get_dataloader,
                               get_trainset_params)
from ..data.sharding import ShardWriter
from ..utils.common import (check_execution_info, collect_execution_info,
                            write_execution_info)
from ..utils.options import (add_common_arguments, add_dataloader_arguments,
                             add_dataset_arguments,
                             add_dataset_preprocessing_arguments,
                             validate_dataset_args)
from ..utils.progress import progress


def parse_args(args, is_write=True):
    parser = ArgumentParser()
    for extend in (add_common_arguments, add_dataset_arguments,
                   add_dataloader_arguments,
                   add_dataset_preprocessing_arguments):
        parser = extend(parser)
    args = validate_dataset_args(parser.parse_args(args))

    args.output.mkdir(exist_ok=True, parents=True)
    args = choose_data_path(args)

    execution_info = collect_execution_info(args)
    check_execution_info(args.output, execution_info, args)
    if is_write:
        write_execution_info(args.output, execution_info)
    return args


def main(args):
    args.output.mkdir(exist_ok=True)
    writer = ShardWriter(args.output, args.samples_per_file)
    loader = get_dataloader(get_trainset_params(args))

    bar = progress(initial=writer.samples_written, total=args.size,
                   unit='sample')
    for batch in loader:
        if writer.samples_written >= args.size:
            break
        before = writer.samples_written
        writer.add(codec.encode_batch(**batch))
        bar.update(writer.samples_written - before)
    writer.flush()
    bar.close()


if __name__ == '__main__':
    main(parse_args(sys.argv[1:]))
