"""The program's own spans (``diffgfdn_torch.utils.profiling``) in a traced
window, and the window's idle gaps labelled by them.

The program records its ``gfdn.*`` spans while a torch profiler records, so
the traced window of a run (``trace.profiled``) leaves them in the program's
recorder; the readers read them there. A version of the program without
spans leaves nothing: :func:`recorded` gives None and the readers read
nothing. The profile holds the spans as annotations only where the program
is asked to annotate them (``benchmark/tools/program_gaps.py``), which
:func:`program_gaps` needs.

:func:`window` repeats ``trace.read``'s window rule, because ``Trace`` keeps
no gap's start: it and :func:`program_gaps` go once ``trace.read`` labels
the gaps by program span itself.
"""

from typing import List, Optional, Tuple

from . import trace as tracing

STEP = "gfdn.step.train"
REPLAY = "gfdn.graph.replay"
EAGER = "gfdn.graph.eager"
PREFIX = "gfdn."
OUTSIDE = "outside"  # the label of a gap that opens with no program span open


def recorded() -> Optional[list]:
    """The spans the program has recorded in this process (each with
    ``name``, ``id``, ``parent``, ``ns``), or None where it records none."""
    from diffgfdn_torch.utils import profiling

    records = getattr(profiling, "records", None)
    spans = records() if records is not None else []
    return spans or None


def steps(spans: list) -> List[Tuple[int, int]]:
    """(duration ns, replay ns) of each training step span: the step's
    whole call, and the part its ``gfdn.graph.replay`` children cover."""
    replay = {}
    for s in spans:
        if s.name == REPLAY and s.parent is not None:
            replay[s.parent] = replay.get(s.parent, 0) + s.ns
    return [(s.ns, replay.get(s.id, 0)) for s in spans if s.name == STEP]


def program_gaps(events) -> List[Tuple[str, float]]:
    """The idle gaps of a profile's window, as ``trace.read`` finds them, in
    time order: (the innermost ``gfdn.*`` span open on the host at the gap's
    start, or ``"outside"``; seconds)."""
    from torch.autograd import DeviceType

    lo, hi, busy = window(events)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]
    gaps, reach = [], lo
    for start, end in busy + [(hi, hi)]:
        if start > reach:
            open_ = [(s, -e, name) for s, e, name in spans if s <= reach < e]
            gaps.append((max(open_)[2] if open_ else OUTSIDE, (start - reach) * 1e-6))
        reach = max(reach, end)
    return gaps


def window(events) -> tuple:
    """(start us, end us, the device's busy intervals within) of the one
    window span of a profile, by ``trace.read``'s rule."""
    from torch.autograd import DeviceType

    host = [e.time_range for e in events
            if e.name == tracing.WINDOW and e.device_type == DeviceType.CPU]
    if not host:
        raise RuntimeError("the profile holds no window span")
    dev_ann = [e.time_range for e in events
               if e.name == tracing.WINDOW and e.device_type == DeviceType.CUDA]
    lo = min([host[0].start] + [d.start for d in dev_ann])
    hi = max([host[0].end] + [d.end for d in dev_ann])
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and e.time_range.end > lo and e.time_range.start < hi]
    busy = tracing._union([(max(e.time_range.start, lo), min(e.time_range.end, hi))
                           for e in device])
    return lo, hi, busy
