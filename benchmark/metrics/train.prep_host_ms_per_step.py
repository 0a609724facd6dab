"""Host milliseconds of a training step outside the step graph's launch:
each ``gfdn.step.train`` span less its ``gfdn.graph.replay`` children (the
EDC mask draw, the refill of the graph's inputs, the schedule's step and
the step's own Python), the mean over the traced window's steps."""

from benchmark.lib import program_spans


def read(run, trace, units):
    steps = program_spans.steps(program_spans.recorded() or [])
    return 1e-6 * sum(n - r for n, r in steps) / len(steps) if steps else None
