"""1 - device busy / wall time of the traced training window, in %."""


def read(run, trace, units):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.window_s > 0 else None
