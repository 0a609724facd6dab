"""The model options of PR 18 in the band-parallel trainer, against the
port's own sequential trainer (fs 8 kHz, nfft 2^12, 24 synthetic receivers,
the 500 / 1000 Hz group of torch_port_helpers' subband configs).

FILTER coupling (order 4), meshgrid SVF heads with the aliasing
regularizer (over 20 ms, ROADMAP C19) and learnable common decay times,
all at once: the band-parallel step, whose loss runs under
``torch.func.vmap`` over the band-stacked parameters, against each band's
sequential ``GFDNTrainer`` step on the same parameters and targets
(losses, gradients and the parameters after one Adam step at rtol = atol =
1e-5, as ``tests/test_torch_subband_steps.py`` holds the default options),
with no op falling back from vmap to a loop (a warning, raised here).
"""

import warnings

import numpy as np
import torch

from diffgfdn_torch.cli import run_subband_training as port_cli
from diffgfdn_torch.config.schema import CouplingMatrixType, FeatureEncodingType
from diffgfdn_torch.data import arrays_from_room_dataset
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer, make_optimizer
from diffgfdn_torch.training.solver import subband_resp
from torch_port_helpers import FS, subband_configs, subband_room_path, subband_rooms

TOL = 1e-5
IDX = torch.arange(8)


def test_band_parallel_step_with_the_options_matches_the_sequential_trainer(
        tmp_path, monkeypatch):
    path = subband_room_path(tmp_path)
    _, room = subband_rooms(path)
    _, cfgs = subband_configs(monkeypatch, path, tmp_path)
    cfgs = cfgs[:2]
    for cfg in cfgs:
        cfg.feedback_loop_config.coupling_matrix_type = CouplingMatrixType.FILTER
        cfg.feedback_loop_config.pu_matrix_order = 4
        cfg.output_filter_config.encoding_type = FeatureEncodingType.MESHGRID
        cfg.output_filter_config.use_svfs = True
        cfg.decay_filter_config.learn_common_decay_times = True
        cfg.trainer_config.use_reg_loss = True
        cfg.trainer_config.output_filt_ir_len_ms = 20.0
    arrays = arrays_from_room_dataset(room)
    trainer = port_cli.band_parallel_trainer(cfgs, room, arrays, np.arange(16), "cpu")
    assert {"feedback_loop.unit_vectors", "feedback_loop.common_decay_times"} <= set(
        trainer.params)
    before = {k: p.detach().clone() for k, p in trainer.params.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a vmap fallback to a loop warns
        totals, losses = trainer.loss_and_grads(IDX)
    assert "reg_loss" in losses
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
