"""AEE evaluation: the port's copies of the JAX package's evaluation
modules."""
from .flow_metrics import (estimate_corresponding_gt_flow, flow_error_dense,
                           prop_flow)
from .testing import evaluate, ravel_config, read_config

__all__ = ['estimate_corresponding_gt_flow', 'flow_error_dense', 'prop_flow',
           'evaluate', 'ravel_config', 'read_config']
