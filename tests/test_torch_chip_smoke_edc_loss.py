"""chip_smoke.py's ``--edc-loss`` measurement rehearsed on the CPU at a small
size: the directional EDC loss and autograd through ``db``, eagerly and
through a StepGraph (which runs eagerly on the CPU), at both row counts;
the two ways' losses and gradients agree, and autograd's graphed step at
the larger shape reports its peak.
"""

from pathlib import Path
import sys

import torch

ROOT = Path(__file__).resolve().parents[1]


def test_edc_loss_check_holds_the_port_to_autograd(monkeypatch, record_property):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "EDC_LOSS_ROWS", {"mlp_batch": 5, "cnn_0.3m": 7})
    monkeypatch.setattr(chip_smoke, "SPATIAL_FS", 1000.0)
    monkeypatch.setattr(chip_smoke, "EDC_LOSS_TIMED", 2)
    for name in ("empty_cache", "synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args, **kwargs: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *args, **kwargs: 0)
    out = chip_smoke.edc_loss_check()
    assert out["edc_len"] == int(max(chip_smoke.DIRECTIONAL_DECAYS) * 1000.0)
    for label in ("mlp_batch", "cnn_0.3m"):
        row = out[label]
        ways = {"port_eager", "port_graphed", "autograd_eager", "autograd_graphed"}
        assert ways <= set(row)
        record_property(f"{label}_loss_rel", row["port_vs_autograd_loss_rel"])
        record_property(f"{label}_grad_rel_l2", max(row["port_vs_autograd_grad_rel_l2"].values()))
        assert row["port_vs_autograd_loss_rel"] <= 1e-6
        assert max(row["port_vs_autograd_grad_rel_l2"].values()) <= 1e-4
    assert set(out["cnn_0.3m"]["autograd_graphed"]) == {"peak_mb"}
