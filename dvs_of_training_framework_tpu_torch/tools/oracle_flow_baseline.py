#!/usr/bin/env python3
"""Constant-flow oracle AEE over a test matrix.

The port's entry point after ``scripts/oracle_flow_baseline.py``.  The
strongest per-frame-pair CONSTANT predictor: for every evaluation window
it is handed the propagated GT itself and plays the single 2-vector
(geometric median or mean, whichever scores lower) that minimises the
AEE over exactly the metric's mask.  On spatially varying GT it keeps an
irreducible residual, which a trained model must beat decisively to show
flow-FIELD estimation rather than global-motion regression; on
constant-translation GT it scores ~0 by construction.  It uses the
evaluation CLI's windows, crops, GT propagation and metric mask (the
port's ``test.py`` and ``evaluation/flow_metrics.py``), and prints the
script's line for every configuration.  ``--test-config`` and the data
root as in ``zero_flow_baseline``.

Usage:
    DVS_DATA_ROOT=<root> python -m \
        dvs_of_training_framework_tpu_torch.tools.oracle_flow_baseline \
        [--test-config dvs_of_training_framework_tpu_torch/config/synth_testing.json]
"""
import argparse
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import test as test_cli
from ..data.augmentation import frame_generator, get_count_image
from ..evaluation.flow_metrics import (constant_flow_oracle,
                                       estimate_corresponding_gt_flow)


def oracle_for_config(dataset, cfg):
    """Mean oracle AEE / %AEE over the config's eval windows."""
    cfg = test_cli.resolve_time_range(cfg, dataset)
    event_crop, gt_crop = test_cli.build_crops(
        dataset.imshape, cfg.test_shape, cfg.crop_type)
    gt = dataset.gt
    totals = np.zeros(2)
    count = 0
    for w, start, stop in frame_generator(
            dataset.events, test_cli.generate_frames(cfg,
                                                     dataset.image_ts)):
        events = event_crop(np.array(w).T).T
        gt_uv = estimate_corresponding_gt_flow(
            gt['x_flow_dist'], gt['y_flow_dist'], gt['timestamps'],
            start, stop)
        gt_flow = gt_crop(np.dstack(gt_uv))
        count_image = get_count_image(events, gt_flow.shape[:2])
        aee, paee, _, _ = constant_flow_oracle(gt_flow, count_image,
                                               cfg.is_car)
        totals += (aee, paee)
        count += 1
    return totals / max(count, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--test-config', type=Path, default=None)
    cli = ap.parse_args(sys.argv[1:] if argv is None else argv)
    args = SimpleNamespace(test_config=cli.test_config)
    for dataset, shared_cfg in test_cli.build_test_matrix(args):
        cfg = SimpleNamespace(**vars(shared_cfg))
        aee, paee = oracle_for_config(dataset, cfg)
        print(f'[{cfg.sequence}, step={cfg.step}] constant-flow oracle '
              f'AEE={aee:.4f} px, %AEE<3px={paee * 100:.2f}')


if __name__ == '__main__':
    main()
