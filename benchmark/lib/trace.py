"""Reading a ``torch.profiler`` trace of a run's traced window: device busy
time, the kernels by name and the device's idle gaps,
each labelled by the harness span the host was in.

The interval arithmetic and the window rule are copies of
``chip_smoke.py``'s ``device_busy_us`` and ``profile_window``.
"""

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import torch

WINDOW = "bench_window"
# the harness's spans around each call into a layer of the program
SPANS = ("fit_step", "valid_step", "normalize", "epoch_read")


@dataclass
class Trace:
    """What the metric readers read of a traced window."""

    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]  # (device kernel name, seconds), in time order
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host span, seconds)


@contextlib.contextmanager
def profiled() -> Iterator[dict]:
    """Profile the block (CPU and CUDA activity) within the window span;
    the yielded dict gets ``"trace"`` (a :class:`Trace`) after the block."""
    from torch.profiler import profile, ProfilerActivity, record_function

    out = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
            torch.cuda.synchronize()
    out["trace"] = read(prof.events())


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def read(events) -> Trace:
    """The :class:`Trace` of a profile holding one ``WINDOW`` span. The
    window is the host span widened to its device annotation (the device
    times, converted to the host's clock, can place a replay's first kernels
    before the host span opens)."""
    from torch.autograd import DeviceType

    host = [e.time_range for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not host:
        raise RuntimeError("the profile holds no window span")
    dev_ann = [e.time_range for e in events
               if e.name == WINDOW and e.device_type == DeviceType.CUDA]
    lo = min([host[0].start] + [d.start for d in dev_ann])
    hi = max([host[0].end] + [d.end for d in dev_ann])
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and e.time_range.end > lo and e.time_range.start < hi]
    busy = _union([(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in device])
    kernels = sorted(((e.time_range.start, e.name, e.time_range.elapsed_us() * 1e-6)
                      for e in device if not e.name.startswith(("Memcpy", "Memset"))))
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name in SPANS)
    gaps, reach = [], lo
    for start, end in busy + [(hi, hi)]:
        if start > reach:
            label = next((name for s, e, name in spans if s <= reach < e), "host")
            gaps.append((label, (start - reach) * 1e-6))
        reach = max(reach, end)
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6,
                 kernels=[(name, sec) for _, name, sec in kernels], gaps=gaps)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, by what the host was doing."""
    by_name: Dict[str, float] = {}
    for name, sec in trace.kernels:
        by_name[name] = by_name.get(name, 0.0) + sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps, key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
