"""Profiling and observability (port of ``utils/profiling.py``).

A ``torch.profiler`` trace context that writes a Chrome trace, and the
program's own spans: named host intervals at the layer boundaries of the
step path (``gfdn.step.train``, ``gfdn.graph.replay``, ...), kept in memory.

Spans record while :func:`recording` is open, or while a ``torch.profiler``
profile records (torch's own ``_is_profiler_enabled`` flag): a profiled run
holds them without asking. Otherwise :func:`span` reads those two flags and
returns a shared null context: no clock read, no allocation. A recorded span
costs two clock reads and two small objects. Only within ``recording(annotate=True)``
(which :func:`trace` opens) does a span, while a torch profiler records,
also open ``record_function(name)``, so that it lies in the profile on the
clock that the profile gives the device's kernels; an annotation costs some
microseconds, which fall in the enclosing span's time. A span opened while
the current CUDA stream is capturing a graph records nothing: it would not
run on a replay.

The recorder is one per process and is meant for one thread.
"""

import contextlib
from pathlib import Path
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler

TRACE_FILE = "trace.json"

_NULL = contextlib.nullcontext()
_recording = False
_annotating = False
_open: List["_Open"] = []  # the spans open now, outermost first
_records: List["Span"] = []
_next_id = 0
_next_serial = 0


class Span(NamedTuple):
    """One closed span; times are ``time.perf_counter_ns()``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the id of the span it was opened in
    serial: int  # its top-level span's: the spans of one step share it
    child_ns: int  # the time its child spans cover

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.ns - self.child_ns


class _Open:
    """A span while it is open."""

    __slots__ = ("name", "id", "parent", "serial", "start_ns", "child_ns", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Open":
        global _next_id, _next_serial
        self.id = _next_id
        _next_id += 1
        if _open:
            self.parent, self.serial = _open[-1].id, _open[-1].serial
        else:
            self.parent, self.serial = None, _next_serial
            _next_serial += 1
        self.child_ns = 0
        self.annotation = None
        if _annotating and _torch_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        _open.pop()
        if _open:
            _open[-1].child_ns += end - self.start_ns
        _records.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.serial,
                             self.child_ns))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


def span(name: str):
    """A context manager timing the block as the span ``name`` when spans
    record (see the module's docstring), else a shared null context."""
    if not (_recording or _torch_profiler._is_profiler_enabled):
        return _NULL
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _NULL
    return _Open(name)


@contextlib.contextmanager
def recording(annotate: bool = False) -> Iterator[None]:
    """Spans record within the block (with no profiler running too); with
    ``annotate``, each also opens a ``record_function`` while a torch
    profiler records."""
    global _recording, _annotating
    before = _recording, _annotating
    _recording, _annotating = True, annotate or _annotating
    try:
        yield
    finally:
        _recording, _annotating = before


def records() -> List[Span]:
    """The closed spans recorded so far in this process, in closing order."""
    return list(_records)


def clear() -> None:
    """Forget the recorded spans."""
    _records.clear()


def summary(spans: Optional[List[Span]] = None) -> Dict[str, Dict[str, float]]:
    """{name: {"count", "total_ms", "self_ms"}} of ``spans`` (default: all
    recorded); self time is a span's duration less what its children cover."""
    out: Dict[str, Dict[str, float]] = {}
    for s in _records if spans is None else spans:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += s.ns * 1e-6
        row["self_ms"] += s.self_ns * 1e-6
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where a
    card is present) and write its Chrome trace to ``<log_dir>/trace.json``
    (view in chrome://tracing or Perfetto). The trace holds the program's
    ``gfdn.*`` spans as annotations, which :func:`records` keeps too.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with recording(annotate=True), torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / TRACE_FILE))
