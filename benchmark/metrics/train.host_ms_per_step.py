"""Host milliseconds a training step call takes (``fit_step``, no
synchronize: the input refills, the EDC mask draw, the replay's launch and
the schedule's step), the mean over the traced window's steps."""


def read(run, trace, units):
    steps = run.host_step_s
    return 1e3 * sum(steps) / len(steps) if steps else None
