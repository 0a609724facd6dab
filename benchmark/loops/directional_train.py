"""Directional grid training, epoch by epoch as the port's
``DirectionalGFDNTrainer.fit_indexed`` runs them, without checkpoint files
or an early stop: at each epoch's start the training receivers in a seeded
order, padded to full batches; then the graphed ``fit_step`` of each batch
(the EDC mask drawn and the io gains normalized inside the step), the
validation batches through ``valid_step`` and one host read of the epoch's
losses. The epoch itself is ``grid_train``'s; what differs is the set-up:
the spatial grid, the directional model and its trainer, as
``run_training_anisotropic_decay_var_receiver_pos`` builds them.

A unit is one epoch. Set-up makes the grid, the model with the seed's
weights, the trainer with the positions and amplitudes on the device, takes
the check's probe (:func:`probe`) and runs the first epoch (which captures
the step graphs) through :func:`unit` itself: its first three steps are the
ones the reference follows.
"""

import numpy as np
import torch

from benchmark.lib import checks, data, directional_checks, port, spatial_grid
from benchmark.loops import grid_train

REFERENCE_STEPS = grid_train.REFERENCE_STEPS
unit, end_to_end, attempts, release = (grid_train.unit, grid_train.end_to_end,
                                       grid_train.attempts, grid_train.release)


def room_dataset(grid: spatial_grid.SpatialGrid, ambi_order: int):
    """The port's spatial grid container over the benchmark's grid: the
    positions, amplitudes, decay times and directions (no SRIR: the
    directional trainer reads none)."""
    from diffgfdn_torch.data.spatial_dataset import SpatialRoomDataset

    channels = (ambi_order + 1) ** 2
    return SpatialRoomDataset(
        num_rooms=len(grid.room_dims), sample_rate=grid.fs, source_position=grid.source[None],
        receiver_position=grid.receivers,
        rirs=np.zeros((grid.receivers.shape[0], channels, 0), np.float32),
        common_decay_times=grid.decay_times, room_dims=grid.room_dims,
        room_start_coord=grid.room_starts, band_centre_hz=grid.band_hz,
        amplitudes=grid.amplitudes, sph_directions=grid.directions, ambi_order=ambi_order,
        grid_spacing_m=grid.spacing_m)


def build_model(cfg, room, seed: int, device):
    """The port's directional model with the benchmark's weights: (model, weights)."""
    from diffgfdn_torch.training import build_gfdn_model

    model = build_gfdn_model(cfg, common_decay_times=room.common_decay_times,
                             band_centre_hz=room.band_centre_hz, variant="directional",
                             device=device, desired_directions=room.desired_directions)
    params = dict(model.named_parameters())
    weights = port.draw_weights({k: tuple(p.shape) for k, p in params.items()}, seed, device)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    return model, weights


def trainer_for(cfg, room, model, train_idx: np.ndarray, device):
    """A ``DirectionalGFDNTrainer`` with the positions and amplitudes on the
    device, its optimizer and its schedule, as the directional solver and
    ``fit_indexed`` make them before the first epoch."""
    from diffgfdn_torch.data.spatial_dataset import arrays_from_spatial_dataset
    from diffgfdn_torch.losses import make_decay_envelopes
    from diffgfdn_torch.ops.basic import ms_to_samps
    from diffgfdn_torch.training.optim import make_optimizer
    from diffgfdn_torch.training.solver import steps_per_epoch, subband_resp
    from diffgfdn_torch.training.trainer import DirectionalGFDNTrainer

    tc = cfg.trainer_config
    cdt = np.asarray(room.common_decay_times)
    envelopes = make_decay_envelopes(cdt.reshape(-1)[: cfg.num_groups],
                                     ms_to_samps(float(np.max(cdt)) * 1e3, cfg.sample_rate),
                                     cfg.sample_rate)
    trainer = DirectionalGFDNTrainer(
        model, tc, steps_per_epoch=steps_per_epoch(len(train_idx), tc.batch_size),
        common_decay_times=cdt, subband_filter_resp=subband_resp(cfg, room.num_freq_bins),
        sample_rate=cfg.sample_rate, device=device, directional_envelopes=envelopes)
    trainer.optimizer, trainer.scheduler = make_optimizer(tc, model, trainer.steps_per_epoch)
    trainer.upload_arrays(arrays_from_spatial_dataset(room))
    return trainer


def setup(run) -> None:
    from diffgfdn_torch.data.spatial_dataset import split_by_grid_resolution

    cfg = port.port_config(run.preset)
    with run.phase("grid"):
        grid = spatial_grid.make_grid(run.config["data"], run.seed)
        room = room_dataset(grid, cfg.ambi_order)
    with run.phase("model"):
        model, weights = build_model(cfg, room, run.seed, run.device)
    with run.phase("trainer"):
        train_idx, valid_idx = split_by_grid_resolution(room, cfg.trainer_config.grid_resolution_m)
        trainer = trainer_for(cfg, room, model, train_idx, run.device)
    trainer.mask_generator.manual_seed(run.seed % 2 ** 63)
    bs = min(cfg.trainer_config.batch_size, len(train_idx))
    vbs = min(cfg.trainer_config.batch_size, max(1, len(valid_idx)))
    run.state.update(
        grid=grid, trainer=trainer, train_idx=train_idx, bs=bs, vbs=vbs,
        valid=[torch.as_tensor(b, dtype=torch.long, device=run.device)
               for b in port.valid_batches(valid_idx, vbs)],
        order=data.rng_for(run.seed, 1), weights=weights)
    run.readings.update(parts=[], losses=[], fit_losses=[], batches=[], normalized=[],
                        norm_states=[], scales=[])
    with run.phase("probe"):
        run.readings["probe"] = probe(trainer, run.state["valid"][0], run.seed)
    with run.phase("first_epoch"):
        unit(run, observe=_Observer(run))


def probe(trainer, idx: torch.Tensor, seed: int) -> dict:
    """The program's side of the check's probe (``directional_checks``), at
    the state it holds, on the receivers ``idx``, eagerly and with no
    optimizer step: the data term's gradient of each loop leaf, each
    receiver's and direction's EDC error alone (the trainer's loss on that
    receiver, that row of the analysis matrix and that column of the
    amplitudes), and the spectral term's gradient of each loop leaf at
    |z| = ``PROBE_RADIUS``."""
    from diffgfdn_torch.losses import directional_edc_loss_from_sh

    model = trainer.model
    params = dict(model.named_parameters())
    leaves = [params[n] for n in checks.LOOP_STATE]
    mask = directional_checks.probe_mask(
        trainer.edc_mask_length(trainer.data["z_values"].shape[0]), seed, trainer.device)
    batch = trainer.gather(idx)
    losses = trainer._losses(batch, mask)
    data = torch.autograd.grad(sum(losses[t] for t in directional_checks.DATA_TERMS), leaves)
    with torch.no_grad():
        h = model(batch)
        if trainer.subband_filter_resp is not None:
            h = h * trainer.subband_filter_resp
        amps = batch["target_common_slope_amps"]
        directions = [[float(directional_edc_loss_from_sh(
            h[b:b + 1], model.analysis_matrix[j:j + 1], amps[b:b + 1, j:j + 1],
            trainer.directional_envelopes, trainer.mixing_time_samps, trainer.max_ir_len_samps,
            mask, use_matmul_irfft=trainer.use_mxu_fft))
            for j in range(model.analysis_matrix.shape[0])] for b in range(h.shape[0])]
    off = dict(batch, z_values=batch["z_values"] * directional_checks.PROBE_RADIUS)
    spectral = torch.autograd.grad(trainer._losses(off, mask)["spectral_loss"], leaves)
    return {"mask": mask, "batch": idx.cpu().numpy(),
            "data_grads": {n: g.detach().double().cpu() for n, g in zip(checks.LOOP_STATE, data)},
            "spectral_grads": {n: g.detach().double().cpu()
                               for n, g in zip(checks.LOOP_STATE, spectral)},
            "directions": directions}


class _Observer(grid_train._Observer):
    """``grid_train``'s observer of the first epoch, its data loss the
    directional EDC loss alone (the model has no EDR)."""

    def step(self, k: int, idx: torch.Tensor, total: torch.Tensor, aux: dict) -> None:
        if k >= REFERENCE_STEPS:
            return
        r = self.run.readings
        self._normalized(self._step_normalized())
        parts = {n: float(v) for n, v in aux.items()}
        r["parts"].append(parts)
        r["losses"].append(float(total))
        r["fit_losses"].append(sum(parts[t] for t in directional_checks.DATA_TERMS))
        r["batches"].append(idx.cpu().numpy())
        params = dict(self.trainer.model.named_parameters())
        self.before = {n: params[n].detach().clone() for n in checks.LOOP_STATE}
        if k == 0:
            state = self.trainer.optimizer.state
            r["grad_norms"] = {
                n: float(torch.linalg.vector_norm(state[p]["exp_avg"])) / (1.0 - checks.ADAM_BETA1)
                if "exp_avg" in state.get(p, {}) else 0.0 for n, p in params.items()}
        if k == REFERENCE_STEPS - 1:
            w = self.run.state["weights"]
            r["change_norms"] = {
                n: float(torch.linalg.vector_norm(p.detach() - w[n])) for n, p in params.items()}

    def valid(self, j: int, vidx: torch.Tensor, losses: dict, steps: int) -> None:
        if j:
            return
        r = self.run.readings
        r["valid_loss"] = float(sum(losses[t] for t in directional_checks.DATA_TERMS))
        r["valid_batch"] = vidx.cpu().numpy()
        r["valid_masks_before"] = steps  # the EDC masks the epoch's steps drew
        r["valid_params"] = {n: p.detach().clone()
                             for n, p in self.trainer.model.named_parameters()}


def check(run) -> dict:
    r, st = run.readings, run.state
    reference = directional_checks.DirectionalTraining(
        run.preset, st["grid"], st["weights"], r["batches"], run.seed, run.device,
        follow=r["normalized"], follow_m=directional_checks.program_m(r)).run()
    reference["scales"] = directional_checks.reference_scales(run.preset, st["grid"],
                                                              r["norm_states"], run.device)
    reference["valid_loss"] = directional_checks.reference_valid_loss(
        run.preset, st["grid"], r, run.seed, run.device)
    pr = r["probe"]
    theirs = directional_checks.reference_probe(run.preset, st["grid"], st["weights"],
                                                pr["batch"], pr["mask"], run.device)
    return {**checks.training_numbers(r, reference),
            **directional_checks.probe_numbers(pr, theirs)}
