"""The part of the traced window's idle device time (``device.idle_share.train``)
that opens while the host is inside a call into the program's step path (the
harness's spans around ``fit_step``, ``valid_step`` and the normalization),
over the window, in %."""

PROGRAM_CALLS = ("fit_step", "valid_step", "normalize")


def read(run, trace, units):
    if trace.window_s <= 0:
        return None
    return 100.0 * sum(s for label, s in trace.gaps if label in PROGRAM_CALLS) / trace.window_s
