"""Host-side batch schema of the port."""
from .schema import Batch, EventBuffer, pad_batch, pad_events

__all__ = ['Batch', 'EventBuffer', 'pad_batch', 'pad_events']
