"""Captured training steps (port of ``training/scan.py``).

The JAX trainers never dispatch a training step op by op: each epoch of
``GFDNTrainer``, ``BandParallelTrainer`` and ``SpatialSamplingTrainer`` is
one jitted ``lax.scan`` (``scan_epoch``), and the single-position and
colorless trainers run one jitted step each. The counterpart here is a step
captured once in a CUDA graph and replayed. This module owns that skeleton:

* :class:`StepGraph` runs one step closure over static input buffers (the
  batch-index row, the EDC mask, the band-parallel keep vector). The host
  refills the buffers with ``copy_`` before each call, and the closure reads
  its inputs only from them.
* On CUDA tensors the first :data:`WARMUP_STEPS` calls run the closure
  eagerly on a side stream (one a card, shared by every graph). They are
  steps of the run, and they create what a capture must find in place:
  Adam's state, cuFFT plans, cuBLAS workspaces, the kernels' libraries. The
  next call captures the closure with ``torch.cuda.graph`` and replays it,
  and every later call refills the buffers and replays. A capture that
  fails raises: there is no eager fallback.
* On CPU tensors every call runs the same closure on the same buffers,
  eagerly, so the CPU tests exercise the plumbing that the graph relies on.
* :class:`StepGraphs` keeps the graphs of one trainer (one per step kind and
  input shapes), all in one memory pool.

What a caller must keep in mind:

* Anything the closure reads that is not a static input is captured by
  address: the parameters, the optimizer's state and its learning-rate
  tensors (``optim.make_optimizer``). Replace none of them after the capture
  (``optimizer.load_state_dict`` replaces both): drop the graphs instead
  (:meth:`StepGraphs.clear`). Change them in place only.
* A replay returns the closure's outputs as captured: the same tensors,
  overwritten by the next replay of any graph in the pool. Read or copy them
  before that.
* Python in the closure runs at capture only: a host read there breaks the
  capture, and a Python switch (``kernels.dispatch.plain_versions``) is
  frozen at its capture-time value. A replay under another value raises.
* The kernel wrappers count their launches in Python, which a replay does
  not run: the counts seen during the capture are added again on every
  later replay (:class:`ReplayCounts`).
* A capture forbids CUDA calls that are not stream-ordered, from any thread.
  Python's cyclic garbage collector could run mid-capture and destroy
  another graph held in a dead cycle (a trainer and its closures), so it is
  paused while a step is captured, and a captured graph drops its closure,
  leaving no cycle through the trainer.
"""

import contextlib
import gc
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from ..kernels import counted_wrappers
from ..kernels.dispatch import plain_on_card

WARMUP_STEPS = 1  # eager steps on the side stream before the capture

Inputs = Dict[str, torch.Tensor]

# the side stream of each card, shared by every step graph of the process:
# PyTorch keeps a cuBLAS workspace for each stream that runs a product, for
# the life of the process, so a stream per graph would leave one behind with
# every trainer (some 50 MB a trial of the MLP search)
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream of the card ``device`` that step graphs warm up
    and capture on."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


class ReplayCounts:
    """The launch counts of a captured step, added again on each replay.

    ``counters()`` gives {name: object with a ``launches`` count}; the kernel
    wrappers by default. :meth:`recording` notes how far each count moved
    while a step was captured. Those launches are the capture's first replay,
    which the capture's call runs; :meth:`replayed` adds them once for each
    later replay.
    """

    def __init__(self, counters: Callable[[], Dict[str, Any]] = counted_wrappers):
        self.counters = counters
        self.per_replay: Dict[str, int] = {}

    @contextlib.contextmanager
    def recording(self) -> Iterator[None]:
        before = {name: c.launches for name, c in self.counters().items()}
        yield
        after = {name: c.launches for name, c in self.counters().items()}
        self.per_replay = {name: after[name] - before[name] for name in after
                           if after[name] != before[name]}

    def replayed(self) -> None:
        counters = self.counters()
        for name, n in self.per_replay.items():
            counters[name].launches += n


@contextlib.contextmanager
def _collector_paused() -> Iterator[None]:
    """Python's cyclic garbage collector off within the block."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """One step closure ``step(inputs)`` over static input buffers.

    ``inputs`` is {name: tensor}: the buffers are allocated like the first
    call's values, on ``device``, and every call copies its values into them
    (same shapes). ``pool`` is the CUDA graph memory pool to capture into.
    """

    def __init__(self, step: Callable[[Inputs], Any], device: torch.device,
                 pool: Optional[tuple] = None):
        self.step = step
        self.device = device
        self.pool = pool
        self.inputs: Optional[Inputs] = None
        self.outputs: Any = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts = ReplayCounts()
        self.eager_steps = 0
        self.replays = 0
        self.warmup_s = 0.0  # wall time of the warm-up steps, synchronized
        self.capture_s = 0.0  # wall time of the capture and its first replay
        self._plain: Optional[bool] = None
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _fill(self, values: Inputs) -> None:
        if self.inputs is None:
            self.inputs = {k: torch.empty_like(v, device=self.device) for k, v in values.items()}
        if values.keys() != self.inputs.keys():
            raise ValueError(f"step inputs {sorted(values)} != {sorted(self.inputs)}")
        for k, v in values.items():
            if v.shape != self.inputs[k].shape:
                raise ValueError(f"step input {k}: shape {tuple(v.shape)} != "
                                 f"{tuple(self.inputs[k].shape)}")
            self.inputs[k].copy_(v)

    def __call__(self, **values: torch.Tensor) -> Any:
        self._fill(values)
        if self.device.type != "cuda":
            return self.step(self.inputs)
        if self.graph is not None:
            return self._replay()
        if self._stream is None:
            self._stream = side_stream(self.device)
        if self.eager_steps < WARMUP_STEPS:
            return self._warm_up()
        return self._capture()

    def _warm_up(self) -> Any:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self.step(self.inputs)
        main.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        self.eager_steps += 1
        self.warmup_s += time.perf_counter() - t0
        return out

    def _capture(self) -> Any:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        self._plain = plain_on_card()
        with self.counts.recording(), _collector_paused():
            with torch.cuda.graph(graph, pool=self.pool, stream=self._stream):
                self.outputs = self.step(self.inputs)
        self.graph = graph
        self.step = None
        graph.replay()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        return self.outputs

    def _replay(self) -> Any:
        if plain_on_card() != self._plain:
            raise RuntimeError(
                f"this step was captured {'on the plain versions' if self._plain else 'on the kernels'}"
                ": compare kernels with plain versions on eager steps (scan_epochs=False)")
        self.graph.replay()
        self.counts.replayed()
        self.replays += 1
        return self.outputs


class StepGraphs:
    """The :class:`StepGraph` of each step kind and input shapes of one
    trainer on ``device``, sharing one CUDA graph memory pool.

    Calling ``graphs(kind, step, **inputs)`` runs ``step`` through the graph
    of ``kind`` for these input shapes (None inputs are left out); the first
    call for a kind and shapes makes that graph from ``step``.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: Dict[tuple, StepGraph] = {}
        self._pool = None

    def __call__(self, kind: str, step: Callable[[Inputs], Any],
                 **inputs: Optional[torch.Tensor]) -> Any:
        inputs = {k: v for k, v in inputs.items() if v is not None}
        key = (kind,) + tuple(sorted((k, tuple(v.shape)) for k, v in inputs.items()))
        graph = self._graphs.get(key)
        if graph is None:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = self._graphs[key] = StepGraph(step, self.device, self._pool)
        return graph(**inputs)

    def __iter__(self) -> Iterator[StepGraph]:
        return iter(self._graphs.values())

    def get(self, kind: str) -> Optional[StepGraph]:
        """The first graph of ``kind``, or None."""
        return next((g for key, g in self._graphs.items() if key[0] == kind), None)

    def clear(self) -> None:
        """Drop every graph (after the optimizer or its state was replaced)."""
        self._graphs.clear()
        self._pool = None


class GraphedSteps:
    """What a trainer needs to run its steps through :class:`StepGraphs`.

    ``scan_epochs`` (True by default, as in JAX): :meth:`run_step` runs a
    step closure through the graph of its kind; False runs the same closure
    eagerly. Assigning ``optimizer`` drops every graph, which captured the
    old optimizer's state. Call :meth:`init_graphs` in ``__init__``.

    A sharded trainer sets ``collective_backend`` to its process group's
    backend: its step closures hold collectives (``parallel/collectives.py``).
    NCCL's are captured into the step graph with the rest of the step and
    replayed with it; gloo's cannot be captured, so on CUDA tensors
    :meth:`run_step` raises unless ``scan_epochs`` is False (no eager
    fallback).
    """

    scan_epochs = True
    collective_backend: Optional[str] = None

    def init_graphs(self, device: torch.device) -> None:
        self.graphs = StepGraphs(device)
        self._optimizer: Optional[torch.optim.Optimizer] = None

    @property
    def optimizer(self) -> Optional[torch.optim.Optimizer]:
        return self._optimizer

    @optimizer.setter
    def optimizer(self, value: Optional[torch.optim.Optimizer]) -> None:
        self._optimizer = value
        self.graphs.clear()

    def run_step(self, kind: str, step: Callable[..., Any], **inputs: Optional[torch.Tensor]
                 ) -> Any:
        """``step(**inputs)``, through the graph of ``kind`` with
        ``scan_epochs`` (the inputs become its static buffers; None ones
        stay None)."""
        if not self.scan_epochs:
            return step(**inputs)
        if self.graphs.device.type == "cuda" and self.collective_backend not in (None, "nccl"):
            raise RuntimeError(
                f"a step graph cannot capture {self.collective_backend}'s collectives: "
                "set scan_epochs = False on this trainer, or use NCCL")
        names = tuple(inputs)
        return self.graphs(kind, lambda b: step(**{k: b.get(k) for k in names}), **inputs)

    def run_valid(self, step: Callable[..., Any], batch_size: int,
                  **inputs: Optional[torch.Tensor]) -> Any:
        """``step(**inputs)`` of the validation batch ``inputs["idx"]``: through
        the graph of "valid" when it holds ``batch_size`` items; a shorter
        remainder runs eagerly, as JAX's separate ``valid_step`` for it."""
        if len(inputs["idx"]) == batch_size:
            return self.run_step("valid", step, **inputs)
        return step(**inputs)

    def run_batches(self, kind: str, step: Callable[..., Any],
                    batches: List[Inputs]) -> Iterator[Any]:
        """``step(**batch)`` for each of ``batches`` in turn, yielded: through
        the graph of ``kind`` when all have one layout (the same keys and
        shapes, as JAX's ``_stack`` requires for its scanned epoch); a ragged
        list runs eagerly, as JAX does when ``_stack`` returns None."""
        layouts = {tuple(sorted((k, tuple(v.shape)) for k, v in b.items())) for b in batches}
        for batch in batches:
            yield self.run_step(kind, step, **batch) if len(layouts) == 1 else step(**batch)
