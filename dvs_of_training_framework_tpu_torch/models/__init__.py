"""Model plugins of the port."""
from .evflownet import Model, Predictor, QuantizationLayer
from .optical_flow import BaseOpticalFlow, OpticalFlow

__all__ = ['BaseOpticalFlow', 'Model', 'OpticalFlow', 'Predictor',
           'QuantizationLayer']
