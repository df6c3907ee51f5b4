"""Model flop of the traced windows' steps over their host-clock time,
over the peak of the configuration's compute type, in %; None where the
profiler recorded no device op."""


def read(rec):
    if rec.trace.busy_s <= 0:
        return None
    return 100.0 * rec.flop / rec.trace.window_s / rec.peak_flops
