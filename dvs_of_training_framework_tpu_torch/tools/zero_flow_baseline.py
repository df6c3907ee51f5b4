#!/usr/bin/env python3
"""Zero-flow baseline AEE over a test matrix.

The port's entry point after ``scripts/zero_flow_baseline.py``.  The AEE
of the all-zeros predictor equals the mean GT displacement magnitude
over the masked pixels: the number any trained model must beat to show
genuine motion estimation.  It uses the evaluation CLI's windows, crops,
GT propagation and metric math (the port's ``test.py`` and
``evaluation.evaluate``), and prints the script's line for every
configuration.  ``--test-config`` takes a JSON config (or a YAML one,
with PyYAML); the data root is ``$DVS_DATA_ROOT`` (``raw/``, ``info/``),
which must be set.

Usage:
    DVS_DATA_ROOT=<root> python -m \
        dvs_of_training_framework_tpu_torch.tools.zero_flow_baseline \
        [--test-config dvs_of_training_framework_tpu_torch/config/synth_testing.json]
"""
import argparse
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import test as test_cli
from ..evaluation import evaluate


class ZeroFlow:
    def __init__(self, shape):
        self.shape = tuple(shape)

    def __call__(self, events_list, starts, stops):
        return [np.zeros((*self.shape, 2), np.float32)
                for _ in events_list]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--test-config', type=Path, default=None)
    cli = ap.parse_args(sys.argv[1:] if argv is None else argv)
    args = SimpleNamespace(test_config=cli.test_config)
    for dataset, shared_cfg in test_cli.build_test_matrix(args):
        cfg = SimpleNamespace(**vars(shared_cfg))
        cfg = test_cli.resolve_time_range(cfg, dataset)
        event_crop, gt_crop = test_cli.build_crops(
            dataset.imshape, cfg.test_shape, cfg.crop_type)
        aee, paee = evaluate(ZeroFlow(cfg.test_shape),
                             dataset.events,
                             test_cli.generate_frames(cfg,
                                                      dataset.image_ts),
                             dataset.gt,
                             event_preproc_fun=event_crop,
                             pred_postproc_fun=None,
                             gt_proc_fun=gt_crop,
                             is_car=cfg.is_car)
        print(f'[{cfg.sequence}, step={cfg.step}] zero-flow '
              f'AEE={aee:.4f} px, %AEE<3px={paee * 100:.2f}')


if __name__ == '__main__':
    main()
