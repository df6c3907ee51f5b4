"""Training objective of the port."""
from .loss import (MultiScaleLoss, SingleScaleLoss, combined_loss,
                   match_predictions_to_images)

__all__ = ['MultiScaleLoss', 'SingleScaleLoss', 'combined_loss',
           'match_predictions_to_images']
