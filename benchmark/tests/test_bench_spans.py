"""The readers of the program's spans on the CPU: ``trace.read`` on a fixed
event list gives what it gave before the program had spans, the idle gaps
labelled by the innermost program span, the four readers on synthetic spans
and gaps, and the three host readers on a CPU epoch of a cell."""

import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark.lib import cell, program_spans, trace
from benchmark.tests.conftest import ROOT, small_overrides
from diffgfdn_torch.utils import profiling

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _event(name, device, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=device, time_range=_Range(start, end),
                           is_user_annotation=annotation)


# a window of 103 us: two harness spans, each around a program step, and
# four device kernels and a copy
EVENTS = [
    _event(trace.WINDOW, CPU, 0, 100), _event(trace.WINDOW, CUDA, 2, 103, annotation=True),
    _event("fit_step", CPU, 5, 40), _event("gfdn.step.train", CPU, 6, 39),
    _event("gfdn.graph.fill", CPU, 8, 12), _event("gfdn.graph.replay", CPU, 20, 30),
    _event("valid_step", CPU, 50, 70), _event("gfdn.step.valid", CPU, 51, 69),
    _event("gfdn.graph.eager", CPU, 55, 68), _event("gfdn.step.valid", CUDA, 55, 66, True),
    _event("kernA", CUDA, 10, 25), _event("Memcpy HtoD", CUDA, 26, 27),
    _event("kernB", CUDA, 24, 33), _event("kernC", CUDA, 60, 64), _event("kernA", CUDA, 80, 95),
]


def test_read_gives_the_fields_it_gave_before_the_program_had_spans():
    t = trace.read(EVENTS)
    assert t.window_s == pytest.approx(103e-6) and t.busy_s == pytest.approx(42e-6)
    assert t.kernels == [("kernA", pytest.approx(15e-6)), ("kernB", pytest.approx(9e-6)),
                         ("kernC", pytest.approx(4e-6)), ("kernA", pytest.approx(15e-6))]
    assert t.gaps == [("host", pytest.approx(10e-6)), ("fit_step", pytest.approx(27e-6)),
                      ("valid_step", pytest.approx(16e-6)), ("host", pytest.approx(8e-6))]
    assert trace.breakdown(t, top=2) == {
        "device_ops": [["kernA", pytest.approx(30e-6)], ["kernB", pytest.approx(9e-6)]],
        "idle_gaps": [["fit_step", pytest.approx(27e-6)], ["valid_step", pytest.approx(16e-6)]]}


def test_program_gaps_take_the_innermost_open_program_span():
    gaps = program_spans.program_gaps(EVENTS)
    assert [sec for _, sec in gaps] == [sec for _, sec in trace.read(EVENTS).gaps]
    assert [label for label, _ in gaps] == ["outside", "gfdn.step.train", "gfdn.graph.eager",
                                            "outside"]
    nested = EVENTS + [_event("gfdn.a", CPU, 30, 50), _event("gfdn.b", CPU, 30, 45)]
    assert program_spans.program_gaps(nested)[1][0] == "gfdn.b"


def _span(name, start_ms, end_ms, id_, parent=None):
    return profiling.Span(name, int(start_ms * 1e6), int(end_ms * 1e6), id_, parent, 0, 0)


STEPS = [_span("gfdn.graph.replay", 0.1, 0.4, 1, 0), _span("gfdn.step.train", 0.0, 1.0, 0),
         _span("gfdn.graph.replay", 2.5, 3.0, 3, 2), _span("gfdn.step.train", 2.0, 4.0, 2),
         _span("gfdn.graph.eager", 5.0, 5.8, 5, 4), _span("gfdn.step.valid", 4.9, 6.0, 4)]


def _reader(name):
    return cell.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("spans,expected", [
    (STEPS, {"train.replay_host_ms_per_step": 0.4, "train.prep_host_ms_per_step": 1.1,
             "train.eager_host_ms_per_epoch": 0.4}),
    (STEPS[:4], {"train.replay_host_ms_per_step": 0.4, "train.prep_host_ms_per_step": 1.1,
                 "train.eager_host_ms_per_epoch": 0.0}),
    (None, {"train.replay_host_ms_per_step": None, "train.prep_host_ms_per_step": None,
            "train.eager_host_ms_per_epoch": None}),
])
def test_host_readers_of_the_program_s_spans(monkeypatch, spans, expected):
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    for name, value in expected.items():
        got = _reader(name)(None, None, [{}, {}])
        assert got == (None if value is None else pytest.approx(value)), name


def test_step_host_idle_share_is_the_idle_share_s_part_in_program_calls():
    t = trace.Trace(window_s=0.2, busy_s=0.16, kernels=[], gaps=[
        ("fit_step", 0.01), ("host", 0.02), ("valid_step", 0.005), ("normalize", 0.001),
        ("epoch_read", 0.004)])
    share = _reader("device.idle_share.step_host")(None, t, [{}])
    assert share == pytest.approx(8.0)
    assert share <= _reader("device.idle_share.train")(None, t, [{}]) == pytest.approx(20.0)


def test_the_host_readers_find_the_spans_of_a_cpu_epoch():
    """An epoch of the fullband cell at a small size, on 240 receivers (a
    validation batch of 32 and a remainder), with the program's spans on."""
    overrides = small_overrides("fullband_grid_colorless")
    overrides["data"]["receivers"] = 240
    run, loop = cell.prepare("fullband-train", 2 ** 31 + 9, "cpu", overrides=overrides)
    loop.setup(run)
    profiling.clear()
    t0 = time.perf_counter_ns()
    try:
        with profiling.recording():
            units = [loop.unit(run)]
        wall_ms = (time.perf_counter_ns() - t0) * 1e-6
        steps = program_spans.steps(profiling.records())
        assert len(steps) == units[0]["steps"]
        prep = _reader("train.prep_host_ms_per_step")(run, None, units)
        replay = _reader("train.replay_host_ms_per_step")(run, None, units)
        eager = _reader("train.eager_host_ms_per_epoch")(run, None, units)
        assert replay == 0.0 and 0.0 < prep * len(steps) < wall_ms  # no graphs on the CPU
        assert units[0]["valid"][-1] < run.state["vbs"] and 0.0 < eager < wall_ms
    finally:
        profiling.clear()
        loop.release(run)
