"""Host ms a window spends in the loop's batch_construction region
(padding, stacking and uploading the next window), over the timed
window."""
from harness.readers import per_window_ms


def read(rec):
    return per_window_ms(rec, 'stage_s')
