"""Training objective of the port."""
from .loss import (LOSS_PRECISIONS, MultiScaleLoss, SingleScaleLoss,
                   combined_loss, match_predictions_to_images)

__all__ = ['LOSS_PRECISIONS', 'MultiScaleLoss', 'SingleScaleLoss',
           'combined_loss', 'match_predictions_to_images']
