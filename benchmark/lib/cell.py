"""One run of one cell: find its configuration, traffic mix, loop and
metrics by name, set up, measure a window (or trace one), then judge the
window's outputs against the reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``benchmark/configs/<config>.json``: the preset as run, its source, what
  was cut (``reduced``), what was assumed, and the grid's data recipe;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters; its ``loop``
  names the general loop that reads them, ``benchmark/loops/<loop>.py``;
* ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric;
* ``benchmark/limits/<cell>.json``: the limit of each number compared.
"""

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from . import checks, trace as tracing

ROOT = Path(__file__).resolve().parents[2]


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path) -> ModuleType:
    """A module of the harness by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Run:
    """The state of one run of a cell, shared by its loop and its readers."""

    cell: dict
    config: dict  # the configuration file
    traffic: dict
    limits: Dict[str, float]
    seed: int
    device: torch.device
    tracing: bool = False
    state: Dict[str, Any] = field(default_factory=dict)  # the loop's
    readings: Dict[str, Any] = field(default_factory=dict)  # the program's, for the check
    host_step_s: List[float] = field(default_factory=list)
    phases: Dict[str, float] = field(default_factory=dict)  # set-up seconds by phase

    @property
    def preset(self) -> dict:
        return self.config["preset"]

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times a phase of the set-up (host clock, the device drained)."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.phases[name] = time.perf_counter() - t0

    def span(self, name: str):
        """A harness span around a call into a layer of the program (a
        ``record_function`` when tracing)."""
        if self.tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def prepare(name: str, seed: int, device, root: Path = ROOT, overrides: Optional[dict] = None
            ) -> tuple:
    """(Run, loop module) of the cell ``name``; ``overrides`` replace keys of
    the configuration file (tests run a cell at a small size)."""
    spec = manifest(root)
    cell = next((c for c in spec["workloads"] if c["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload named {name} in BENCHMARK.json")
    bench = root / "benchmark"
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    for key, value in (overrides or {}).items():
        config[key] = value
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    loop = load_module(bench / "loops" / f"{traffic['loop']}.py")
    return Run(cell=cell, config=config, traffic=traffic, limits=limits, seed=seed,
               device=torch.device(device)), loop


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(run: Run, loop: ModuleType, seconds: float) -> tuple:
    """Units of the loop back to back until ``seconds`` have passed; the
    window ends after the device has finished. (units, elapsed seconds)."""
    units = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        units.append(loop.unit(run))
    sync(run.device)
    return units, time.perf_counter() - t0


def per_layer(run: Run, names: List[str], trace, units, root: Path = ROOT) -> Dict[str, dict]:
    """Each per-layer metric of this cell whose reader finds something to read."""
    spec = manifest(root)
    out = {}
    for metric in spec["per_layer"]:
        if metric["name"] not in names:
            continue
        reader = load_module(root / "benchmark" / "metrics" / f"{metric['name']}.py")
        value = reader.read(run, trace, units)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def metrics_of(cell: dict, kind: str, root: Path = ROOT) -> List[str]:
    """The names of the cell's end-to-end or per-layer metrics."""
    spec = manifest(root)
    return [m["name"] for m in spec[kind]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, started: float,
             root: Path = ROOT, overrides: Optional[dict] = None) -> dict:
    """One run: the result's fields, with the numbers compared under ``checks``."""
    run, loop = prepare(name, seed, device, root, overrides)
    loop.setup(run)
    sync(run.device)
    setup_s = time.perf_counter() - started
    print("setup phases (s): " + json.dumps(run.phases), file=sys.stderr)
    run.tracing = trace
    breakdown = None
    if trace:
        with tracing.profiled() as prof:
            units = [loop.unit(run) for _ in range(int(run.traffic["trace_units"]))]
        metrics = per_layer(run, metrics_of(run.cell, "per_layer", root), prof["trace"], units,
                            root)
        breakdown = tracing.breakdown(prof["trace"])
        device = {"busy_s": prof["trace"].busy_s, "window_s": prof["trace"].window_s}
    else:
        units, elapsed = measure(run, loop, seconds)
        metrics = loop.end_to_end(run, units, elapsed)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        wanted = metrics_of(run.cell, "end_to_end", root)
        metrics = {k: v for k, v in metrics.items() if k in wanted}
        device = {}
    if run.device.type == "cuda":
        device.update(platform="gpu", kind=torch.cuda.get_device_name(run.device),
                      count=int(run.cell["chips"]),
                      memory_peak_bytes=int(torch.cuda.max_memory_allocated(run.device)))
    attempted, failed = loop.attempts(run, units)
    loop.release(run)  # the program's state freed before the reference runs
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = loop.check(run)
    print(f"reference check: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    correct, rows = checks.judged(numbers, run.limits)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for n, v, lim in rows}
    return result
