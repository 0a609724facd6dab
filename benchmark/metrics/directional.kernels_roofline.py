"""The hand-written kernels' (B1, B2, B5, B6 on the directional model's 9 x 9
blocks) share of their roofline in the traced window, in %: the least time
of every launch (``costs.bound_ms`` of its bytes and operations at this
cell's shapes, ``benchmark/lib/directional_costs.py``) over the kernels'
device time. The launches of each kernel family are counted in the trace by
symbol; each is given the mean bound of that family's launches in the
epoch."""

from benchmark.lib import costs, directional_costs


def read(run, trace, units):
    if not units or "grid" not in run.state:
        return None
    grid = run.state["grid"]
    s = directional_costs.shapes_of(run.preset, grid.decay_times, grid.directions.shape[1], 0)
    plan = directional_costs.launches(s)
    per_family = {}  # name -> [launches an epoch, bound ms an epoch]
    for kind, times in (("step", units[0]["steps"]), ("valid", len(units[0]["valid"]))):
        for name, shape in plan[kind]:
            entry = per_family.setdefault(name, [0, 0.0])
            entry[0] += times
            entry[1] += times * costs.bound_ms(*costs.COSTS[name](*shape))[0]
    bound = device = 0.0
    for name, (count, ms) in per_family.items():
        seen = sum(1 for k, _ in trace.kernels if costs.WRAPPER_SYMBOLS[name] in k)
        time_s = sum(t for k, t in trace.kernels if costs.FAMILY_PREFIX[name] in k)
        if seen and count:
            bound += seen * ms / count * 1e-3
            device += time_s
    return 100.0 * bound / device if device > 0 else None
