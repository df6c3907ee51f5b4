"""k1 fwd: least time (bytes or operations at the published
peaks, harness/peaks.py) over profiler device time, traced steps, in %."""
from harness.readers import roofline


def read(rec):
    return roofline(rec, 'k1_fwd')
