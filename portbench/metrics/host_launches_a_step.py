"""CUDA runtime calls that put work on the card (kernel and graph
launches, async copies and memsets) a step, traced; None where the
profiler recorded none."""


def read(rec):
    if rec.trace.host_launches <= 0:
        return None
    return rec.trace.host_launches / rec.trace.steps
