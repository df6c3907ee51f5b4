"""Model plugins of the port."""
from .evflownet import Model, Predictor, QuantizationLayer

__all__ = ['Model', 'Predictor', 'QuantizationLayer']
