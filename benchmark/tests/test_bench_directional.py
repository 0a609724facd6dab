"""The ``directional-train`` cell on the CPU at a small size (fs 8 kHz,
decay times 0.05-0.09 s, so nfft 1024; the 847-receiver grid, the preset's
widths and depth): a whole run agrees with the reference, every fault
planted under the timed path (in the program's trainer, kernels' backward,
analysis matrix and loss) reads beyond its limit, the faults the control
plants in the reference move the same numbers, and the cell's two readers
read a synthetic trace."""

import copy
import json
import math
import time

import pytest
import torch

from benchmark.lib import cell, costs, directional_costs, trace
from benchmark.tests.conftest import ROOT

NAME = "directional-train"
CONFIG = "directional_1000Hz_res0.6m"


def small_overrides() -> dict:
    conf = json.loads((ROOT / "benchmark" / "configs" / f"{CONFIG}.json").read_text())
    preset = copy.deepcopy(conf["preset"])
    preset["sample_rate"] = 8000.0
    preset["trainer_config"]["num_freq_bins"] = 1024
    data = dict(conf["data"], sample_rate=8000.0, decay_times_s=[0.05, 0.09, 0.07])
    return {"preset": preset, "data": data}


def run(seconds: float = 0.5) -> dict:
    torch.manual_seed(0)
    return cell.run_cell(NAME, 2 ** 31 + 21, seconds, False, "cpu", time.perf_counter(),
                         overrides=small_overrides())


def test_the_cell_runs_and_agrees_with_the_reference_on_cpu():
    out = run(1.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 8 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_rirs_per_s", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in out["metrics"].values())
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{NAME}.json").read_text())
    assert set(out["checks"]) == set(limits)


def test_the_epoch_is_the_presets_split_and_batches():
    run_, loop = cell.prepare(NAME, 7, "cpu", overrides=small_overrides())
    loop.setup(run_)
    try:
        st = run_.state
        assert len(st["train_idx"]) == 232 and sum(len(v) for v in st["valid"]) == 615
        assert [len(v) for v in st["valid"]] == [32] * 19 + [7]
        unit = loop.unit(run_)
        assert unit == {"rirs": 232, "steps": 8, "valid": [32] * 19 + [7]}
    finally:
        loop.release(run_)


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from diffgfdn_torch.training.trainer import GFDNTrainer

    monkeypatch.setattr(GFDNTrainer, "_step_on",
                        lambda self, batch, mask: self.loss_and_grads(batch, mask))
    out = run()
    assert out["correct"] is False and out["checks"]["change_gap"]["value"] > 0.5


def test_a_normalization_that_leaves_the_gains_unchanged(monkeypatch):
    from diffgfdn_torch.training.trainer import GFDNTrainer

    monkeypatch.setattr(GFDNTrainer, "_normalize_params", lambda self, *a, **k: None)
    out = run()
    assert out["correct"] is False
    assert out["checks"]["norm_gap"]["value"] > out["checks"]["norm_gap"]["limit"]


def test_half_of_each_batch_left_out(monkeypatch):
    from diffgfdn_torch.training.trainer import GFDNTrainer

    gather = GFDNTrainer.gather
    monkeypatch.setattr(GFDNTrainer, "gather",
                        lambda self, idx: gather(self, idx[: max(1, len(idx) // 2)]))
    assert run()["correct"] is False


def test_beams_without_their_order_weights(monkeypatch):
    """The analysis matrix of a plain SH steering (every order weight 1, the
    energy scaling kept) in the program's model."""
    from diffgfdn_torch.training import build

    design = build.build_analysis_matrix
    monkeypatch.setattr(build, "build_analysis_matrix",
                        lambda order, directions, beamformer: design(order, directions, None))
    out = run()
    assert out["correct"] is False
    assert out["checks"]["grad_gap_heads"]["value"] > out["checks"]["grad_gap_heads"]["limit"]


def beyond(out: dict, name: str) -> bool:
    return out["checks"][name]["value"] > out["checks"][name]["limit"]


def test_b6_returning_twice_its_gradient(monkeypatch):
    """The transposed solve's backward (B6) doubled: only the probe's data
    term reaches the loop leaves through it alone."""
    from diffgfdn_torch.kernels import lu

    solve = lu.lut_apply
    monkeypatch.setattr(lu, "lut_apply", lambda f, piv, g: 2.0 * solve(f, piv, g))
    out = run()
    assert out["correct"] is False and beyond(out, "probe_data_grad_gap")


def test_b2_returning_twice_its_gradient(monkeypatch):
    """The inverse's backward (B2) doubled."""
    from diffgfdn_torch.kernels import cinv

    vjp = cinv.neg_ptgpt
    monkeypatch.setattr(cinv, "neg_ptgpt", lambda p, g: 2.0 * vjp(p, g))
    out = run()
    assert out["correct"] is False and beyond(out, "probe_spectral_grad_gap")


def test_directions_permuted(monkeypatch):
    """The analysis matrix's rows rolled by one direction in the program's
    model: each direction's beam paired with its neighbour's amplitudes."""
    import numpy as np

    from diffgfdn_torch.training import build

    design = build.build_analysis_matrix
    monkeypatch.setattr(build, "build_analysis_matrix", lambda order, directions, beamformer:
                        np.roll(np.asarray(design(order, directions, beamformer)), 1, axis=0))
    out = run()
    assert out["correct"] is False and beyond(out, "direction_gap")


def test_the_sparsity_term_doubled(monkeypatch):
    from diffgfdn_torch.training import trainer

    term = trainer.sparsity_loss
    monkeypatch.setattr(trainer, "sparsity_loss", lambda x: 2.0 * term(x))
    out = run()
    assert out["correct"] is False and beyond(out, "sparsity_gap")


def test_the_reference_faults_match_the_programs():
    """Each fault planted in the reference (what the control reads) moves
    the number that the same fault planted in the program moves."""
    from benchmark.lib import checks, directional_checks as dc

    run_, loop = cell.prepare(NAME, 2 ** 31 + 21, "cpu", overrides=small_overrides())
    loop.setup(run_)
    loop.release(run_)
    r, st = run_.readings, run_.state
    pr = r["probe"]
    probe = (run_.preset, st["grid"], st["weights"], pr["batch"], pr["mask"], run_.device)
    sound = dc.reference_probe(*probe)
    args = (run_.preset, st["grid"], st["weights"], r["batches"], run_.seed, run_.device)
    steps = dc.DirectionalTraining(*args, follow=r["normalized"], follow_m=dc.program_m(r)).run()
    for fault, name in (("drive_grad_x2", "probe_data_grad_gap"),
                        ("inverse_grad_x2", "probe_spectral_grad_gap"),
                        ("permuted", "direction_gap")):
        got = dc.probe_numbers(dc.reference_probe(*probe, fault=fault), sound)
        assert got[name] > run_.limits[name], (fault, got)
    doubled = dc.DirectionalTraining(*args, follow=r["normalized"], follow_m=dc.program_m(r),
                                     fault="sparsity_x2").run()
    assert checks.training_numbers(doubled, steps)["sparsity_gap"] > run_.limits["sparsity_gap"]


class _Run:
    """What the readers read of a run: the preset, the grid and the weights."""

    def __init__(self):
        from benchmark.lib import spatial_grid

        conf = json.loads((ROOT / "benchmark" / "configs" / f"{CONFIG}.json").read_text())
        self.preset = conf["preset"]
        self.state = {"grid": spatial_grid.make_grid(conf["data"], 3),
                      "weights": {"w": torch.zeros(1000)}}


def test_the_readers_read_a_synthetic_trace():
    """A window of 3 epochs at the cell's shapes: each launch of the plan 1
    ms of device time, so the roofline share is the plan's mean bound over 1 ms."""
    run_ = _Run()
    units = [{"rirs": 232, "steps": 8, "valid": [32] * 19 + [7]}] * 3
    s = directional_costs.shapes_of(run_.preset, run_.state["grid"].decay_times, 12, 0)
    plan = directional_costs.launches(s)
    kernels = []
    for _ in units:
        for kind, times in (("step", 8), ("valid", 20)):
            kernels += [(f"{costs.WRAPPER_SYMBOLS[name]}<9>(...)", 1e-3)
                        for name, _ in plan[kind] for _ in range(times)]
    t = trace.Trace(window_s=1.0, busy_s=0.9, kernels=kernels)
    mfu = cell.load_module(ROOT / "benchmark" / "metrics" / "directional.step_mfu.py").read(
        run_, t, units)
    roof = cell.load_module(
        ROOT / "benchmark" / "metrics" / "directional.kernels_roofline.py").read(run_, t, units)
    assert 0.0 < mfu < 100.0 and 0.0 < roof < 100.0
    bounds = [costs.bound_ms(*costs.COSTS[n](*shape))[0] for kind, times in
              (("step", 8), ("valid", 20)) for n, shape in plan[kind] for _ in range(times)]
    assert roof == pytest.approx(100.0 * sum(bounds) / len(bounds))

