"""Matched-init convergence of the port's trainer against the JAX package's.

``tools/convergence.py`` ``prepare`` and ``run_jax`` (unchanged) set up the
toy run (fs 8 kHz, nfft 2048, 24 synthetic receivers, scalar heads, a
1 x 16 MLP) and train it through JAX's ``GFDNTrainer.fit_indexed``. The
port's ``GFDNTrainer.fit_indexed(device="cpu")`` trains the same model from
``params0`` (the JAX initial parameters, carried across) with the same
split and seed. The bounds are ``tests/test_training.py``'s for the JAX
trainer against its eager-torch twin: the first epoch's validation EDC
error within 2e-2 dB of JAX's, the final at most JAX's + 0.75 dB, the best
at most JAX's + 0.5 dB. The 12-epoch run of that test is marked slow; a
3-epoch run stays in the quick set. The measured gaps are recorded as test
properties (ROADMAP C24).
"""

import os
from pathlib import Path
import sys

import numpy as np
import pytest

from test_torch_ops import _jax_dump
from torch_port_helpers import one_torch_thread  # noqa: F401 (a module fixture)

ROOT = Path(__file__).resolve().parents[1]


def _port_config(jcfg, train_dir: str):
    from diffgfdn_torch.config.schema import DiffGFDNConfig

    data = _jax_dump(jcfg)
    data["trainer_config"]["train_dir"] = train_dir
    data["trainer_config"]["ir_dir"] = os.path.join(train_dir, "audio")
    return DiffGFDNConfig.from_dict(data)


def run_port(setup, train_dir: str) -> dict:
    """The port's fit_indexed from the JAX initial parameters, same split and seed."""
    from diffgfdn_torch.data import arrays_from_room_dataset, ThreeRoomDataset
    from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
    from diffgfdn_torch.training.trainer import padded_batches
    from diffgfdn_torch.utils.params import load_jax_params
    from tools import convergence

    cfg = _port_config(setup["cfg"], train_dir)
    assert cfg.delay_length_samps == list(setup["cfg"].delay_length_samps)
    room = ThreeRoomDataset(setup["cfg"].room_dataset_path, nfft=convergence.NFFT)
    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device="cpu")
    load_jax_params(model, setup["params0"])
    steps = len(list(padded_batches(setup["train_idx"], convergence.BATCH)))
    trainer = GFDNTrainer(model, cfg.trainer_config, steps,
                          common_decay_times=room.common_decay_times,
                          sample_rate=convergence.FS, device="cpu")
    trainer.patience = 10 ** 9  # a fixed number of epochs, as run_jax
    trainer.fit_indexed(arrays_from_room_dataset(room), setup["train_idx"],
                        setup["valid_idx"], seed=cfg.seed)
    traj = [d["edc_loss"] for d in trainer.individual_valid_loss]
    return {"valid_edc_db": traj, "final_edc_db": traj[-1]}


@pytest.mark.parametrize("epochs", [3, pytest.param(12, marks=pytest.mark.slow)])
def test_matched_init_convergence_tracks_jax(tmp_path, epochs, record_property):
    sys.path.insert(0, str(ROOT))
    from tools import convergence

    setup = convergence.prepare(str(tmp_path / "conv"), max_epochs=epochs)
    ref = convergence.run_jax(setup)
    ours = run_port(setup, str(tmp_path / "conv" / "port"))
    got, want = np.asarray(ours["valid_edc_db"]), np.asarray(ref["valid_edc_db"])
    gaps = {"epoch1": float(got[0] - want[0]),
            "final": float(ours["final_edc_db"] - ref["final_edc_db"]),
            "best": float(got.min() - want.min()),
            "jax": want.tolist(), "port": got.tolist()}
    record_property("valid_edc_db", gaps)
    assert got.shape == want.shape == (epochs,)
    assert np.all(np.isfinite(got))
    assert abs(gaps["epoch1"]) < 2e-2, gaps
    assert gaps["final"] <= 0.75, gaps
    assert gaps["best"] <= 0.5, gaps
