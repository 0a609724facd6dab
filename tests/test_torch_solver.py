"""The port's training entry points end to end on the CPU, at small width.

* ``run_training_var_receiver_pos`` trains both head kinds for two epochs
  (fs 8 kHz, nfft 2^12, batch 4) and writes JAX-format checkpoints, an
  optimizer-state sidecar per epoch, the .mat exports and the RIR wavs; the
  JAX package loads the last checkpoint and serves the same H as the port's
  trained model, to <= 2e-3 relative L2 (the H bound of test_torch_models.py);
* a run resumed after its first epoch ends where an uninterrupted run ends;
* the CLI trains from a YAML file, sends a config with ``ir_path`` to the
  single-position solver (and refuses ``--resume`` for it) and one with
  ``ambi_order`` to the directional solver.
"""

import jax
import numpy as np
import pytest
from scipy.io import loadmat
import torch
import yaml

from diffgfdn_torch.cli.run_model import main as cli_main
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import spatial_dataset
from diffgfdn_torch.training import run_training_var_receiver_pos
from diffgfdn_torch.training import solver as port_solver
from diffgfdn_torch.utils.params import jax_params_from_torch
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset, gather_batch
from diffgfdn_tpu.training.build import build_gfdn_model as jax_build_gfdn_model
from diffgfdn_tpu.training.checkpoints import load_checkpoint as jax_load_checkpoint
from torch_port_helpers import raw_config, rel_l2, rooms

NFFT = 4096
BATCH = 4
H_TOL = 2e-3
MODEL_INPUTS = ("z_values", "listener_position", "norm_listener_position",
                "target_early_response")


def small_run_config(tmp_path, svf: bool, epochs: int = 2) -> dict:
    raw = raw_config(tmp_path, svf, nfft=NFFT, batch=BATCH)
    raw["trainer_config"].update(
        max_epochs=epochs, ir_dir=str(tmp_path / "ir"), use_colorless_loss=svf,
        use_asym_spectral_loss=svf, use_edc_mask=svf, save_true_irs=True,
        hold_out_test_set=dict(ratio=0.1, seed=4314),
    )
    return raw


@pytest.mark.parametrize("svf", [True, False], ids=["svf_heads", "scalar_heads"])
def test_two_epochs_write_checkpoints_that_jax_serves(tmp_path, svf, record_property):
    raw = small_run_config(tmp_path, svf)
    jax_room, port_room = rooms(tmp_path, svf, NFFT)
    trainer, model = run_training_var_receiver_pos(
        DiffGFDNConfig.from_dict(raw), port_room, export_irs=True, device="cpu"
    )
    train_dir = tmp_path / f"train_svf{svf}_zcTrue"
    names = {p.name for p in (train_dir / "checkpoints").iterdir()}
    assert {"model_e-1.ckpt", "model_e0.ckpt", "model_e1.ckpt", "opt_e0.pt", "opt_e1.pt"} <= names
    assert len(trainer.train_loss) == len(trainer.valid_loss) == 2
    assert np.all(np.isfinite(trainer.train_loss + trainer.valid_loss))
    assert set(trainer.individual_train_loss[-1]) >= {"edc_loss", "edr_loss"}
    assert loadmat(str(train_dir / "losses.mat"))["train_loss"].size == 2
    assert "coupled_feedback_matrix" in loadmat(str(train_dir / "parameters_opt.mat"))
    wavs = [p.name for p in (tmp_path / "ir").iterdir()]
    assert any(w.startswith("ir_(") for w in wavs) and any(w.startswith("true_ir_(") for w in wavs)

    params = jax_load_checkpoint(train_dir, 1)
    jax_model = jax_build_gfdn_model(
        JaxDiffGFDNConfig.model_validate(raw), common_decay_times=jax_room.common_decay_times,
        band_centre_hz=jax_room.band_centre_hz, use_pallas_inverse=False,
    )
    batch = gather_batch(arrays_from_room_dataset(jax_room), np.array([0, 1, 5, 8]))
    batch = {k: np.asarray(batch[k]) for k in MODEL_INPUTS}
    out = jax.jit(jax_model.apply)(params, batch)  # (H, sub-FDN outputs) with the colorless loss
    h_ref = np.asarray(out[0] if isinstance(out, tuple) else out)
    with torch.no_grad():
        h = model({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    direct = batch["target_early_response"]
    err = rel_l2(h - direct, h_ref - direct)
    record_property("h_rel_l2", err)
    assert err <= H_TOL


def test_resumed_run_ends_where_an_uninterrupted_run_ends(tmp_path):
    raw = small_run_config(tmp_path, svf=False)
    _, room = rooms(tmp_path, False, NFFT)
    raw["trainer_config"]["train_dir"] = str(tmp_path / "straight")
    _, straight = run_training_var_receiver_pos(DiffGFDNConfig.from_dict(raw), room,
                                                device="cpu")
    raw["trainer_config"].update(train_dir=str(tmp_path / "resumed"), max_epochs=1)
    run_training_var_receiver_pos(DiffGFDNConfig.from_dict(raw), room, device="cpu")
    raw["trainer_config"]["max_epochs"] = 2
    trainer, resumed = run_training_var_receiver_pos(DiffGFDNConfig.from_dict(raw), room,
                                                     resume=True, device="cpu")
    assert len(trainer.train_loss) == 1  # only epoch 1 ran
    flat = jax.tree_util.tree_leaves_with_path(jax_params_from_torch(straight))
    got = dict(jax.tree_util.tree_leaves_with_path(jax_params_from_torch(resumed)))
    for path, leaf in flat:
        np.testing.assert_allclose(got[path], leaf, rtol=1e-5, atol=1e-7)


def test_cli_trains_from_yaml_and_refuses_unported_variants(tmp_path, monkeypatch):
    raw = small_run_config(tmp_path, svf=False, epochs=1)
    rooms(tmp_path, False, NFFT)
    raw["room_dataset_path"] = str(tmp_path / "srirs.pkl")
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(raw))
    cli_main(["-c", str(path), "--device", "cpu"])
    train_dir = tmp_path / "train_svfFalse_zcTrue"
    assert (train_dir / "checkpoints" / "model_e0.ckpt").exists()
    assert (train_dir / "config_args.pickle").exists()
    # a config with ir_path goes to the single-position solver (trained end to
    # end in test_torch_single_pos.py), which takes no --resume
    single = []
    monkeypatch.setattr(port_solver, "run_training_single_pos",
                        lambda cfg, **kw: single.append((cfg.ir_path, kw)))
    path.write_text(yaml.safe_dump(dict(raw, ir_path="rir.wav")))
    cli_main(["-c", str(path), "--device", "cpu"])
    assert single == [("rir.wav", {"device": torch.device("cpu")})]
    with pytest.raises(SystemExit):
        cli_main(["-c", str(path), "--device", "cpu", "--resume"])
    # a config with ambi_order goes to the directional solver on the spatial
    # dataset (trained end to end in test_torch_directional_solver.py)
    calls = []
    monkeypatch.setattr(port_solver, "run_training_anisotropic_decay_var_receiver_pos",
                        lambda cfg, room, **kw: calls.append((cfg.ambi_order, room, kw)))
    monkeypatch.setattr(spatial_dataset, "SpatialThreeRoomDataset", lambda p: p)
    path.write_text(yaml.safe_dump(dict(raw, ambi_order=1)))
    cli_main(["-c", str(path), "--device", "cpu"])
    assert calls == [(1, raw["room_dataset_path"], {"resume": False,
                                                    "device": torch.device("cpu")})]
