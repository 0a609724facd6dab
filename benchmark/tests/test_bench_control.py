"""The control on the card at a size a test run holds: the reference put in
the program's place with TF32 products (``benchmark/control.py``), judged by
the cells' own limits, comes out not correct for both trainers, and so do
the planted faults (120 receivers, every other size as the cells run). Runs
only with a CUDA card: ``python -m pytest benchmark/tests -m cuda`` on a
machine with one."""

import gc
import json

import pytest

from benchmark import control
from benchmark.lib import cell, checks
from benchmark.tests.conftest import ROOT, small_overrides


def readings(name: str, config: str, device) -> tuple:
    """(limits, readings) of a cell with 120 receivers, at its own nfft."""
    receivers = small_overrides(config)["data"]["receivers"]
    conf = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    run, loop = cell.prepare(name, 2 ** 31 + 5, device,
                             overrides={"data": dict(conf["data"], receivers=receivers)})
    control.tf32(False)
    loop.setup(run)
    loop.release(run)
    gc.collect()
    return run.limits, control.training_readings(run)


def judged(limits: dict, numbers: dict) -> bool:
    return checks.judged(numbers, limits)[0]


TRAIN_CELLS = [("fullband-train", "fullband_grid_colorless"),
               ("three-room-train", "three_room_example")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,config", TRAIN_CELLS)
def test_tf32_control_and_faults_fail_the_trainer(card, name, config):
    limits, read = readings(name, config, card)
    assert judged(limits, read["program"])
    for fault in ("control", "half_batch", "frozen", "norm_skipped"):
        assert not judged(limits, dict(read["program"], **read[fault])), fault
