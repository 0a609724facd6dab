"""Host milliseconds of a training step spent in the step graph's launch
(the program's ``gfdn.graph.replay`` spans within each ``gfdn.step.train``:
the replay-mode check, ``graph.replay()`` and the launch counts' update),
the mean over the traced window's steps."""

from benchmark.lib import program_spans


def read(run, trace, units):
    steps = program_spans.steps(program_spans.recorded() or [])
    return 1e-6 * sum(r for _, r in steps) / len(steps) if steps else None
