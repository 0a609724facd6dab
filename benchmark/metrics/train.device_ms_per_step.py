"""Device-busy milliseconds of the traced window over its training steps
(the validation batches' and the normalization's device work included)."""


def read(run, trace, units):
    steps = sum(u["steps"] for u in units)
    return 1e3 * trace.busy_s / steps if steps and trace.busy_s > 0 else None
