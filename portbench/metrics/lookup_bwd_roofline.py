"""E-RAFT's correlation lookup, bwd: the least time of its compulsory
bytes over a traced step's iterations (harness/eraft_work.py, at the
published HBM peak) over the profiler's device time of F.grid_sample's
bwd kernel, which only the lookup runs in eraft.pair_b8, in %."""
from harness.eraft_work import lookup_roofline


def read(rec):
    return lookup_roofline(rec, 'bwd')
