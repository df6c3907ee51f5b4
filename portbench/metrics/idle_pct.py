"""Share of the traced windows in which no device op ran, in %; None
where the profiler recorded no device op."""


def read(rec):
    if rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
