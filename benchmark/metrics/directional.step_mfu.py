"""The traced window's operations, counted from the directional
configuration's shapes (``benchmark/lib/directional_costs.py``: training
steps, each with its normalization, and validation batches), over its wall
time and the H100's fp32 peak, in %."""

from benchmark.lib import costs, directional_costs


def read(run, trace, units):
    if not units or trace.window_s <= 0 or "grid" not in run.state:
        return None
    grid = run.state["grid"]
    s = directional_costs.shapes_of(run.preset, grid.decay_times, grid.directions.shape[1],
                                    sum(w.numel() for w in run.state["weights"].values()))
    flops = 0.0
    for u in units:
        flops += u["steps"] * directional_costs.train_step_flops(s)
        flops += sum(sum(directional_costs.forward_flops(s, b).values()) for b in u["valid"])
    return 100.0 * flops / trace.window_s / costs.H100_FP32_FLOP_PER_S
