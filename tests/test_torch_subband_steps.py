"""The port's band-parallel subband trainer against its own sequential trainer,
and the subband CLI on the CPU (fs 8 kHz, nfft 2^12, 24 synthetic receivers,
bands at 500 / 1000 / 2000 Hz in two architecture groups).

* one band-parallel step of the 500 / 1000 Hz group against the sequential
  ``GFDNTrainer`` of each band (each band's own config, filter response and
  target features): the losses, gradients and the parameters after one Adam
  step at rtol = atol = 1e-5, as ``tests/test_band_parallel_parity.py``
  holds the JAX package's two trainers;
* a stopped band keeps its parameters exactly while its Adam state advances;
* each kernel's autograd function runs once per step for the whole group;
* ``python -m diffgfdn_torch.cli.run_subband_training --band-parallel
  --device cpu`` trains for one epoch, writes each band's checkpoints, and
  ``--infer`` merges the bands into broadband RIRs.
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.cli import run_subband_training as port_cli
from diffgfdn_torch.data import arrays_from_room_dataset
from diffgfdn_torch.kernels import cinv as cinv_mod, lu as lu_mod, sos as sos_mod
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer, load_checkpoint
from diffgfdn_torch.training import make_optimizer
from diffgfdn_torch.training.solver import subband_resp
from diffgfdn_torch.utils.params import load_jax_params
from torch_port_helpers import FS, SUBBAND_NFFT, subband_configs, subband_room_path
from torch_port_helpers import subband_rooms

TOL = 1e-5
IDX = torch.arange(8)


@pytest.fixture
def group(tmp_path, monkeypatch):
    """The 500 / 1000 Hz group's band-parallel trainer, its configs and data."""
    path = subband_room_path(tmp_path)
    _, room = subband_rooms(path)
    _, cfgs = subband_configs(monkeypatch, path, tmp_path)
    arrays = arrays_from_room_dataset(room)
    trainer = port_cli.band_parallel_trainer(cfgs[:2], room, arrays, np.arange(16), "cpu")
    return trainer, cfgs[:2], room, arrays


def test_band_parallel_step_matches_the_sequential_trainer_per_band(group):
    trainer, cfgs, room, arrays = group
    before = {k: p.detach().clone() for k, p in trainer.params.items()}
    totals, losses = trainer.loss_and_grads(IDX)
    grads = {k: p.grad.clone() for k, p in trainer.params.items()}
    trainer.optimizer.step()
    for b, cfg in enumerate(cfgs):
        model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                                 device="cpu")
        for name, p in model.named_parameters():
            assert torch.equal(p.detach(), before[name][b]), name  # same seeded start
        seq = GFDNTrainer(model, cfg.trainer_config, trainer.steps_per_epoch,
                          common_decay_times=room.common_decay_times,
                          subband_filter_resp=subband_resp(cfg), sample_rate=FS, device="cpu")
        # the band's own targets: the dataset's RIRs times the band's response
        seq.features = {k: v[b] for k, v in trainer.band_feats.items()}
        seq.upload_arrays(arrays)
        total, aux = seq.loss_and_grads(seq.gather(IDX))
        np.testing.assert_allclose(float(totals[b]), float(total), rtol=TOL, atol=TOL)
        for k, v in aux.items():
            np.testing.assert_allclose(float(losses[k][b]), float(v), rtol=TOL, atol=TOL)
        optimizer, _ = make_optimizer(cfg.trainer_config, model, trainer.steps_per_epoch)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(grads[name][b].numpy(), p.grad.numpy(),
                                       rtol=TOL, atol=TOL, err_msg=name)
        optimizer.step()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(trainer.params[name][b].detach().numpy(),
                                       p.detach().numpy(), rtol=TOL, atol=TOL, err_msg=name)


def test_band_parallel_svf_heads_and_edc_mask_match_the_sequential_trainer(
        tmp_path, monkeypatch):
    """SVF heads (the cascade kernel's backward under the band axis) and one
    EDC mask shared by the bands, as the JAX trainer shares its step key."""
    path = subband_room_path(tmp_path)
    _, room = subband_rooms(path)
    _, cfgs = subband_configs(monkeypatch, path, tmp_path)
    for cfg in cfgs[:2]:
        cfg.output_filter_config.use_svfs = True
        cfg.trainer_config.use_edc_mask = True
    arrays = arrays_from_room_dataset(room)
    trainer = port_cli.band_parallel_trainer(cfgs[:2], room, arrays, np.arange(16), "cpu")
    mask = torch.bernoulli(torch.full((SUBBAND_NFFT - trainer.mixing_time_samps,), 0.5),
                           generator=torch.Generator().manual_seed(4))
    totals, _ = trainer.loss_and_grads(IDX, mask)
    for b, cfg in enumerate(cfgs[:2]):
        model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                                 device="cpu")
        seq = GFDNTrainer(model, cfg.trainer_config, 1,
                          common_decay_times=room.common_decay_times,
                          subband_filter_resp=subband_resp(cfg), sample_rate=FS, device="cpu")
        seq.features = {k: v[b] for k, v in trainer.band_feats.items()}
        seq.upload_arrays(arrays)
        total, _ = seq.loss_and_grads(seq.gather(IDX), mask)
        np.testing.assert_allclose(float(totals[b]), float(total), rtol=TOL, atol=TOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(trainer.params[name].grad[b].numpy(), p.grad.numpy(),
                                       rtol=TOL, atol=TOL, err_msg=name)


def test_band_features_are_the_targets_times_the_band_response(group):
    trainer, cfgs, room, arrays = group
    b = 1
    filtered = np.fft.irfft(
        np.fft.rfft(arrays.target_rir_time[:, :SUBBAND_NFFT], SUBBAND_NFFT)
        * subband_resp(cfgs[b]), SUBBAND_NFFT).astype(np.float32)
    seq = GFDNTrainer(build_gfdn_model(cfgs[b], room.common_decay_times, room.band_centre_hz,
                                       device="cpu"),
                      cfgs[b].trainer_config, 1, common_decay_times=room.common_decay_times,
                      sample_rate=FS, device="cpu")
    arrays.target_rir_time = filtered
    seq.precompute_target_features(arrays)
    for k, v in seq.features.items():
        ref = trainer.band_feats[k][b]
        assert float(torch.max(torch.abs(v - ref))) <= 1e-3 * float(torch.max(torch.abs(ref)))


def test_stopped_band_stays_frozen(group):
    trainer = group[0]
    before = {k: p.detach().clone() for k, p in trainer.params.items()}
    trainer.step(IDX, active=np.array([1.0, 0.0], np.float32))
    changed = any(not torch.equal(p[0], before[k][0]) for k, p in trainer.params.items())
    assert changed
    for k, p in trainer.params.items():
        assert torch.equal(p[1], before[k][1]), k
        # the stopped band's Adam moments advanced, as the JAX trainer's do
        assert torch.any(trainer.optimizer.state[p]["exp_avg"][1] != 0), k


def test_each_kernel_function_runs_once_per_group_step(group, monkeypatch):
    trainer = group[0]
    calls = {}
    for mod, name in ((cinv_mod, "cinv"), (cinv_mod, "neg_ptgpt"), (lu_mod, "lu_solve"),
                      (lu_mod, "lut_apply"), (sos_mod, "sos_cascade"),
                      (sos_mod, "sos_cascade_backward")):
        def counted(*args, fn=getattr(mod, name), name=name):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        monkeypatch.setattr(mod, name, counted)
    trainer.step(IDX)
    # the absorption cascades are fixed buffers: no cascade backward
    assert calls == {"cinv": 1, "neg_ptgpt": 1, "lu_solve": 1, "lut_apply": 1,
                     "sos_cascade": 1}


def test_subband_cli_trains_and_infers_on_the_cpu(tmp_path, monkeypatch):
    path = subband_room_path(tmp_path)
    monkeypatch.setattr(port_cli, "BAND_MLP_PARAMS",
                        {500.0: (1, 16), 1000.0: (1, 16), 2000.0: (2, 16)})
    out = tmp_path / "out"
    args = ["--dataset", str(path), "--freqs", "500", "1000", "2000", "--num-freq-bins",
            str(SUBBAND_NFFT), "--max-epochs", "1", "--device", "cpu", "--train-dir", str(out)]
    port_cli.main(args + ["--band-parallel"])
    for freq, layers in ((500, 1), (1000, 1), (2000, 2)):
        cfg = port_cli.create_config(float(freq), str(path), str(out), SUBBAND_NFFT,
                                     sample_rate=FS, max_epochs=1)
        tree = load_checkpoint(cfg.trainer_config.train_dir, 0)
        mlp = tree["params"]["output_scalars"]["MLP_0"]
        assert sum(k.startswith("Dense_") for k in mlp) == layers + 2
        model = build_gfdn_model(cfg, np.array([0.5, 0.5, 0.5]), device="cpu")
        load_jax_params(model, tree)
    port_cli.main(args + ["--infer"])
    rirs = np.load(out / "broadband_rirs.npy")
    assert rirs.shape == (24, SUBBAND_NFFT) and np.isfinite(rirs).all()


def test_subband_cli_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    path = subband_room_path(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--dataset", str(path), "--band-parallel", "--train-dir",
                       str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
