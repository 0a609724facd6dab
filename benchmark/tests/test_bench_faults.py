"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (on the CPU at a small size, the look for a chip
skipped): a step that leaves the state unchanged, half of each batch left
out with the mean taken over the rest, and an answer altered where it is
produced, and an io-gain normalization that leaves the gains unchanged. One
chip a cell: no exchange between chips to leave out."""

import time

import pytest
import torch

from benchmark.lib import cell
from benchmark.tests.conftest import ROOT, small_overrides


def run(name: str, config: str, root=ROOT) -> dict:
    torch.manual_seed(0)
    return cell.run_cell(name, 2 ** 31 + 11, 0.5, False, "cpu", time.perf_counter(), root=root,
                         overrides=small_overrides(config))


TRAIN_CELLS = [("fullband-train", "fullband_grid_colorless"),
               ("three-room-train", "three_room_example")]


@pytest.mark.parametrize("name,config", TRAIN_CELLS)
def test_a_step_that_leaves_the_state_unchanged(monkeypatch, name, config):
    from diffgfdn_torch.training.trainer import GFDNTrainer

    def step_on(self, batch, mask):
        return self.loss_and_grads(batch, mask)  # no normalization, no optimizer step

    monkeypatch.setattr(GFDNTrainer, "_step_on", step_on)
    out = run(name, config)
    assert out["correct"] is False and out["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("name,config", TRAIN_CELLS)
def test_a_normalization_that_leaves_the_gains_unchanged(monkeypatch, name, config):
    from diffgfdn_torch.training.trainer import GFDNTrainer

    monkeypatch.setattr(GFDNTrainer, "_normalize_params", lambda self, *a, **k: None)
    out = run(name, config)
    assert out["correct"] is False and out["checks"]["norm_gap"]["value"] > 0.1


@pytest.mark.parametrize("name,config", TRAIN_CELLS)
def test_half_of_each_batch_left_out(monkeypatch, name, config):
    from diffgfdn_torch.training.trainer import GFDNTrainer

    gather = GFDNTrainer.gather
    monkeypatch.setattr(GFDNTrainer, "gather",
                        lambda self, idx: gather(self, idx[: max(1, len(idx) // 2)]))
    out = run(name, config)
    assert out["correct"] is False


@pytest.mark.parametrize("name,config", TRAIN_CELLS)
def test_a_step_loss_altered_where_it_is_produced(monkeypatch, name, config):
    from diffgfdn_torch.training import trainer as trainer_module

    losses = trainer_module._omni_losses

    def altered(*args, **kwargs):
        out = losses(*args, **kwargs)
        out["edr_loss"] = out["edr_loss"] * 1.01
        return out

    monkeypatch.setattr(trainer_module, "_omni_losses", altered)
    out = run(name, config)
    assert out["correct"] is False and out["checks"]["fit_loss_gap"]["value"] > 1e-3


@pytest.mark.parametrize("name,config", TRAIN_CELLS)
def test_sound_runs_of_the_same_sizes_are_correct(name, config):
    assert run(name, config)["correct"] is True
