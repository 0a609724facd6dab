"""The directional solver and CLI against the JAX package on the CPU.

``run_training_anisotropic_decay_var_receiver_pos`` trains 2 epochs in both
packages at the size of the JAX package's own directional solver test
(fs 4 kHz, a 1.2 m grid of 44 receivers, ambi order 1, nfft from the
dataset's decay times), from the same parameters (the JAX run's initial
checkpoint, loaded into the port's model where its solver builds it), with
the 2.4 m grid split and the same batch order. Bounds per epoch, as
test_torch_c1_fullband_losses.py: each loss term (train and valid) within
1e-3 relative after epoch 0 and 1e-2 after epoch 1. The EDC mask is off
(the two packages draw different bits) and the colorless spectral term runs
at weight 0 (on |z| = 1 it cannot be held to JAX, ROADMAP C2).
"""

import numpy as np
import pytest
import torch
import yaml

from diffgfdn_torch.cli.run_model import main as cli_main
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import split_by_grid_resolution
from diffgfdn_torch.training import DirectionalGFDNTrainer, load_checkpoint
from diffgfdn_torch.training import solver as port_solver
from diffgfdn_torch.utils.params import load_jax_params, torch_state_from_jax
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.training.checkpoints import load_checkpoint as jax_load_checkpoint
from diffgfdn_tpu.training.solver import run_training_anisotropic_decay_var_receiver_pos
from torch_port_helpers import directional_raw_config, spatial_rooms

FS = 4000.0
TERM_TOL = (1e-3, 1e-2)  # per epoch 0, 1


def _raw(tmp_path, epochs: int = 2) -> dict:
    raw = directional_raw_config(tmp_path, 1, nfft=512, batch=8, max_epochs=epochs,
                                 grid_resolution_m=2.4, use_edc_mask=False,
                                 spectral_loss_weight=0.0)
    raw["sample_rate"] = FS
    return raw


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dir_solver")
    jroom, room = spatial_rooms(tmp, fs=FS, decay_times=(0.04, 0.06, 0.05), rir_len_s=0.15)
    raw = _raw(tmp)
    jdir, pdir = str(tmp / "jax"), str(tmp / "port")
    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=jdir)))
    jtrainer, _ = run_training_anisotropic_decay_var_receiver_pos(jcfg, jroom)
    init = jax_load_checkpoint(jdir, -1)

    def build_from_jax_init(*args, **kwargs):
        return load_jax_params(build(*args, **kwargs), init)

    build = port_solver.build_gfdn_model
    port_solver.build_gfdn_model = build_from_jax_init
    try:
        cfg = DiffGFDNConfig.from_dict(dict(raw, trainer_config=dict(raw["trainer_config"],
                                                                     train_dir=pdir)))
        trainer, model = port_solver.run_training_anisotropic_decay_var_receiver_pos(
            cfg, room, device="cpu")
    finally:
        port_solver.build_gfdn_model = build
    return {"jax": jtrainer, "port": trainer, "model": model, "room": room, "dirs": (jdir, pdir),
            "cfg": cfg}


def test_solver_losses_match_jax_per_epoch(two_epochs, record_property):
    jax_t, port_t = two_epochs["jax"], two_epochs["port"]
    assert len(port_t.train_loss) == len(jax_t.train_loss) == 2
    for epoch, tol in enumerate(TERM_TOL):
        for split in ("train", "valid"):
            ref = getattr(jax_t, f"individual_{split}_loss")[epoch]
            got = getattr(port_t, f"individual_{split}_loss")[epoch]
            assert sorted(got) == sorted(ref) == ["edc_loss", "sparsity_loss", "spectral_loss"]
            for term in ("edc_loss", "sparsity_loss"):
                err = abs(got[term] - ref[term]) / abs(ref[term])
                record_property(f"{split}_{term}_e{epoch}", err)
                assert err <= tol, (split, term, epoch, got[term], ref[term])
            assert got["spectral_loss"] == ref["spectral_loss"] == 0.0


def test_solver_split_and_checkpoints(two_epochs):
    """The preset's grid split (14 train, 30 valid receivers at 2.4 m), the
    directional trainer, and checkpoints that read back to the model."""
    trainer, model, room = two_epochs["port"], two_epochs["model"], two_epochs["room"]
    train, valid = split_by_grid_resolution(room, 2.4)
    assert (len(train), len(valid)) == (14, 30)
    assert isinstance(trainer, DirectionalGFDNTrainer) and trainer.steps_per_epoch == 2
    saved = torch_state_from_jax(load_checkpoint(two_epochs["dirs"][1], 1))
    for key, value in model.state_dict().items():
        assert torch.equal(saved[key], value), key
    # the JAX package reads the port's checkpoint tree as its own
    jtree = jax_load_checkpoint(two_epochs["dirs"][1], 1)
    ref = jax_load_checkpoint(two_epochs["dirs"][0], 1)
    assert set(jtree["params"]) == set(ref["params"])


def test_cli_trains_a_directional_config(tmp_path):
    """``run_model`` dispatches a config with ``ambi_order`` to the
    directional solver on the spatial dataset at ``room_dataset_path``."""
    _, room = spatial_rooms(tmp_path, fs=FS, decay_times=(0.04, 0.06, 0.05), rir_len_s=0.15)
    raw = _raw(tmp_path, epochs=1)
    raw["room_dataset_path"] = str(tmp_path / "spatial.pkl")
    path = tmp_path / "directional.yml"
    path.write_text(yaml.safe_dump(raw))
    cli_main(["-c", str(path), "--device", "cpu"])
    train_dir = tmp_path / "train_dir1"
    assert (train_dir / "checkpoints" / "model_e0.ckpt").exists()
    assert (train_dir / "config_args.pickle").exists()
    assert (train_dir / "parameters_opt.mat").exists()
    tree = load_checkpoint(str(train_dir), 0)
    assert "sh_output_scalars" in tree["params"]
    assert np.isfinite(np.asarray(tree["params"]["output_gains"])).all()
