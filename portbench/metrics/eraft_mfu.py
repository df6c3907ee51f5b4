"""E-RAFT's model flop of the traced windows' steps (harness/flops.py over
configs/eraft.py: every convolution of every iteration) over their
host-clock time, over the peak of the configuration's compute type, in %:
``metrics/mfu.py``'s reading, for the E-RAFT cell; None where the profiler
recorded no device op."""
from metrics.mfu import read  # noqa: F401
