"""The hand-written kernels' (B1-B6) share of their roofline in the traced
window, in %: the least time of every launch (``costs.bound_ms`` of its
bytes and operations at its shape, the shapes as the configuration's
training epoch launches them) over the kernels' device time. The launches
of each kernel family are counted in the trace; each is given the mean
bound of that family's launches in the epoch."""

from benchmark.lib import costs


def read(run, trace, units):
    if not units:
        return None
    s = costs.shapes_of(run.preset, run.state["grid"].decay_times, 0)
    plan = costs.train_launches(s, units[0]["valid"])
    per_family = {}  # name -> [launches an epoch, bound ms an epoch]
    for kind, launches in plan.items():
        times = units[0]["steps"] if kind == "step" else 1
        if kind.startswith("valid_"):
            times = units[0]["valid"].count(int(kind.split("_")[1]))
        for name, shape in launches:
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
