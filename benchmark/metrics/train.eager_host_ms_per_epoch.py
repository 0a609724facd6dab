"""Host milliseconds an epoch spends in step closures run outside any step
graph (the program's ``gfdn.graph.eager`` spans: the validation remainder
batch), over the traced window's epochs; 0.0 when the program recorded
spans and none was eager."""

from benchmark.lib import program_spans


def read(run, trace, units):
    spans = program_spans.recorded()
    if spans is None or not units:
        return None
    return 1e-6 * sum(s.ns for s in spans if s.name == program_spans.EAGER) / len(units)
