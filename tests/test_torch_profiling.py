"""The program's spans (``diffgfdn_torch/utils/profiling.py``).

Off, a span is one shared null context that reads no clock and opens no
``record_function``; on, it records its name, start and end, its parent and
the serial of its top-level span, and :func:`summary` gives each name's
count, total and self time. A torch profile turns the spans on without
annotations; :func:`profiling.trace` annotates them, and its Chrome trace
holds them. On the card (marked ``cuda``; this file imports
neither JAX nor the JAX package): a step graph's replay records
``gfdn.graph.replay``, and a span opened inside a capture records nothing.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling.py
"""

import pytest
import torch

from diffgfdn_torch.training.scan import StepGraph
from diffgfdn_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: step graphs are captured only on the card")
    return torch.device("cuda")


def _refuse(what):
    def raiser(*args, **kwargs):
        raise AssertionError(f"an idle span called {what}")
    return raiser


def test_an_idle_span_reads_no_clock_and_opens_no_annotation(monkeypatch):
    monkeypatch.setattr(profiling.time, "perf_counter_ns", _refuse("perf_counter_ns"))
    monkeypatch.setattr(torch.profiler, "record_function", _refuse("record_function"))
    first = profiling.span("gfdn.a")
    assert profiling.span("gfdn.b") is first
    with first, profiling.span("gfdn.c"):
        pass
    assert profiling.records() == [] and profiling.summary() == {}


def test_recorded_spans_nest_share_a_serial_and_give_self_time(monkeypatch):
    clock = iter(range(0, 10 ** 6, 10))  # each read 10 ns after the last
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    monkeypatch.setattr(torch.profiler, "record_function", _refuse("record_function"))
    with profiling.recording():
        for _ in range(2):
            with profiling.span("gfdn.step"):  # 0 .. 70, then 80 .. 150
                with profiling.span("gfdn.fill"):  # 10 .. 20
                    pass
                with profiling.span("gfdn.replay"):  # 30 .. 60
                    with profiling.span("gfdn.fill"):  # 40 .. 50
                        pass
    with profiling.span("gfdn.after"):
        pass
    spans = profiling.records()
    assert [s.name for s in spans] == ["gfdn.fill", "gfdn.fill", "gfdn.replay", "gfdn.step"] * 2
    for k in (0, 4):
        fill, inner, replay, step = spans[k:k + 4]
        assert (fill.parent, inner.parent, replay.parent, step.parent) == (
            step.id, replay.id, step.id, None)
        assert {s.serial for s in spans[k:k + 4]} == {spans[0].serial + k // 4}
    step = spans[3]
    assert (step.start_ns, step.ns, step.child_ns, step.self_ns) == (0, 70, 40, 30)
    assert spans[2].self_ns == 20 and spans[7].start_ns == 80
    assert profiling.summary() == {
        "gfdn.fill": {"count": 4, "total_ms": pytest.approx(40e-6),
                      "self_ms": pytest.approx(40e-6)},
        "gfdn.replay": {"count": 2, "total_ms": pytest.approx(60e-6),
                        "self_ms": pytest.approx(40e-6)},
        "gfdn.step": {"count": 2, "total_ms": pytest.approx(140e-6),
                      "self_ms": pytest.approx(60e-6)},
    }
    assert profiling.summary(spans[:1]) == {
        "gfdn.fill": {"count": 1, "total_ms": pytest.approx(10e-6),
                      "self_ms": pytest.approx(10e-6)}}


def test_a_profile_turns_spans_on_and_its_trace_holds_them(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("gfdn.step.train"):
            with profiling.span("gfdn.graph.fill"):
                torch.ones(8).sum()
    text = (tmp_path / "trace" / profiling.TRACE_FILE).read_text()
    assert '"gfdn.step.train"' in text and '"gfdn.graph.fill"' in text
    assert [s.name for s in profiling.records()] == ["gfdn.graph.fill", "gfdn.step.train"]
    assert profiling.span("gfdn.after") is profiling.span("gfdn.after2")


def test_a_bare_profile_records_spans_without_annotations(monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        monkeypatch.setattr(torch.profiler, "record_function", _refuse("record_function"))
        with profiling.span("gfdn.step.train"):
            with profiling.span("gfdn.graph.replay"):
                torch.ones(8).sum()
        monkeypatch.undo()
    assert [s.name for s in profiling.records()] == ["gfdn.graph.replay", "gfdn.step.train"]
    assert not any(e.name.startswith("gfdn.") for e in prof.events())


def test_annotations_open_only_under_a_profile_within_annotated_recording(monkeypatch):
    opened = []

    class _Annotation:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", _Annotation)
    with profiling.recording(annotate=True):
        with profiling.span("gfdn.unprofiled"):
            pass
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.recording(), profiling.span("gfdn.profiled"):
                pass
    with profiling.recording(), profiling.span("gfdn.plain"):
        pass
    assert opened == ["gfdn.profiled"]
    assert [s.name for s in profiling.records()] == ["gfdn.unprofiled", "gfdn.profiled",
                                                     "gfdn.plain"]


@pytest.mark.cuda
def test_a_replay_records_its_span_and_a_capture_records_nothing(cuda_device):
    def step(inputs):
        with profiling.span("gfdn.inside"):
            return inputs["x"] * 2.0

    graph = StepGraph(step, cuda_device, torch.cuda.graph_pool_handle())
    x = torch.arange(4.0, device=cuda_device)
    with profiling.recording():
        for k in range(4):  # the warm-up, the capture, two replays
            out = graph(x=x + k)
    torch.cuda.synchronize()
    assert torch.equal(out, (x + 3) * 2.0)
    counts = {name: row["count"] for name, row in profiling.summary().items()}
    assert counts == {"gfdn.graph.fill": 4, "gfdn.inside": 1, "gfdn.graph.replay": 2}
    assert (graph.eager_steps, graph.replays) == (1, 2)  # the one inside is the warm-up's
