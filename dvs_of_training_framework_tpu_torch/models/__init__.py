"""Model plugins of the port and their loader."""
from .evflownet import Model, OpticalFlow, Predictor, QuantizationLayer
from .loader import (filter_kwargs, init_model, load_model_class,
                     load_plugin, load_vis_flow, output_axes)
from .optical_flow import BaseOpticalFlow

__all__ = ['BaseOpticalFlow', 'Model', 'OpticalFlow', 'Predictor',
           'QuantizationLayer', 'filter_kwargs', 'init_model',
           'load_model_class', 'load_plugin', 'load_vis_flow',
           'output_axes']
