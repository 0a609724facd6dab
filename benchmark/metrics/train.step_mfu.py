"""The traced window's operations, counted from the configuration's shapes
(``benchmark/lib/costs.py``: training steps, validation batches, the
normalizations), over its wall time and the H100's fp32 peak, in %."""

from benchmark.lib import costs


def read(run, trace, units):
    if not units or trace.window_s <= 0:
        return None
    s = costs.shapes_of(run.preset, run.state["grid"].decay_times,
                        sum(w.numel() for w in run.state["weights"].values()))
    flops = 0.0
    for u in units:
        flops += u["steps"] * costs.train_step_flops(s)
        flops += sum(sum(costs.forward_flops(s, b).values()) for b in u["valid"])
        flops += costs.normalize_flops(s) if s.svf else 0.0
    return 100.0 * flops / trace.window_s / costs.H100_FP32_FLOP_PER_S
