"""Profiling and observability helpers (port of ``utils/profiling.py``).

A ``torch.profiler`` trace context that writes a Chrome trace, a
steps-per-second counter, the synthesis x-real-time, and the epoch-summary
and one-line JSON metric strings of the JAX package.
"""

import contextlib
from dataclasses import dataclass, field
import json
import logging
from pathlib import Path
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("diffgfdn_torch")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where a
    card is present) and write its Chrome trace to ``<log_dir>/trace.json``
    (view in chrome://tracing or Perfetto). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / TRACE_FILE))


@dataclass
class StepTimer:
    """Steps/sec counter with warmup discard; a ``with`` block is one step.

    The host clock is read on entry and exit: the caller synchronizes the
    card inside the block when the step is asynchronous."""

    warmup: int = 1
    _times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._times.append(time.perf_counter() - self._t0)

    @property
    def steps_per_sec(self) -> float:
        steady = self._times[self.warmup :] or self._times
        return len(steady) / sum(steady) if steady else 0.0

    @property
    def mean_step_ms(self) -> float:
        steady = self._times[self.warmup :] or self._times
        return 1e3 * sum(steady) / len(steady) if steady else 0.0


def x_realtime(audio_seconds: float, wall_seconds: float) -> float:
    """Synthesis speed as a multiple of real time."""
    return audio_seconds / max(wall_seconds, 1e-12)


def get_str_results(
    epoch: Optional[int] = None,
    train_loss: Optional[List[float]] = None,
    time_s: Optional[float] = None,
    individual_losses: Optional[List[Dict]] = None,
) -> str:
    """Epoch summary string: epoch, last train loss, time and last loss terms."""
    parts = []
    if epoch is not None:
        parts.append(f"epoch: {epoch:3d}")
    if train_loss:
        parts.append(f"train_loss: {train_loss[-1]:6.4f}")
    if time_s is not None:
        parts.append(f"time: {time_s:6.4f}s")
    if individual_losses:
        for key, value in individual_losses[-1].items():
            parts.append(f"{key}: {value: .3f}")
    return ", ".join(parts)


def emit_metric(metric: str, value: float, unit: str,
                vs_baseline: Optional[float] = None) -> str:
    """One-line JSON metric record, logged and returned."""
    line = json.dumps({"metric": metric, "value": value, "unit": unit,
                       "vs_baseline": vs_baseline})
    logger.info(line)
    return line
