"""Host-side batch schema and the batch upload of the port."""
from .prefetch import prefetch_to_device
from .schema import Batch, EventBuffer, pad_batch, pad_events

__all__ = ['Batch', 'EventBuffer', 'pad_batch', 'pad_events',
           'prefetch_to_device']
