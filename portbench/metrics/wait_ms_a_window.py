"""Host ms a window spends in the loop's logging region (the metric
flush's blocking fetch), over the timed window."""
from harness.readers import per_window_ms


def read(rec):
    return per_window_ms(rec, 'wait_s')
