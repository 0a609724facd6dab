"""Grid training, epoch by epoch as the port's ``GFDNTrainer.fit_indexed``
runs them, without checkpoint files or an early stop: at each epoch's
start the receivers in a seeded order, padded to full batches, and the
io-gain normalization (SVF heads); then the graphed ``fit_step`` of each
batch, the validation batches through ``valid_step`` and one host read of
the epoch's losses.

A unit is one epoch. Set-up makes the grid, the model with the seed's
weights, the trainer with its targets on the device, and runs the first
epoch (which captures the step graphs) through :func:`unit` itself: its
first three steps are the ones the reference follows.
"""

import math
import time

import numpy as np
import torch

from benchmark.lib import checks, data, port

REFERENCE_STEPS = 3


def setup(run) -> None:
    cfg = port.port_config(run.preset)
    with run.phase("grid"):
        grid = data.make_grid(run.config["data"], run.seed)
        room = port.room_dataset(grid, cfg.trainer_config.num_freq_bins)
    with run.phase("model"):
        model, weights = port.build_model(cfg, grid, run.seed, run.device)
    with run.phase("trainer"):
        train_idx, valid_idx = port.splits(cfg, grid.rirs.shape[0])
        trainer = port.trainer_for(cfg, room, model, train_idx, run.device)
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
    with run.phase("first_epoch"):
        unit(run, observe=_Observer(run))


class _Observer:
    """Keeps what the check compares of the first epoch: each normalization
    the first steps hold (the state before it and the gains after it), each
    of the first steps' losses, the first gradient as Adam got it, each
    leaf's change after the last of them, and the first validation batch's
    losses with the parameters it was computed from."""

    def __init__(self, run):
        self.run = run
        self.trainer = run.state["trainer"]
        w = run.state["weights"]
        self.before = {n: w[n].detach().clone() for n in checks.LOOP_STATE}

    def _normalized(self, gains: dict) -> None:
        r = self.run.readings
        r["normalized"].append(gains)
        r["norm_states"].append(self.before)
        r["scales"].append(checks.program_scales(self.before["input_gains"], gains["input_gains"],
                                                 self.trainer.model.num_groups))

    def normalized(self) -> None:
        """The io gains as the epoch's normalization left them (SVF heads)."""
        m = self.trainer.model
        self._normalized({n: getattr(m, n).detach().clone() for n in checks.IO_GAINS})

    def _step_normalized(self) -> dict:
        """The io gains as this step's normalization left them (scalar heads,
        inside the step): the step's parameters less its Adam update, worked
        out from Adam's state after the step."""
        out = {}
        opt = self.trainer.optimizer
        for group in opt.param_groups:
            lr = float(group["lr"])
            beta1, beta2 = group["betas"]
            for p in group["params"]:
                name = next(n for n, q in self.trainer.model.named_parameters() if q is p)
                if name not in checks.IO_GAINS:
                    continue
                st = opt.state.get(p)
                if not st:  # no update: the optimizer got nothing
                    out[name] = p.detach().clone()
                    continue
                t = float(st["step"])
                denom = torch.sqrt(st["exp_avg_sq"]) / math.sqrt(1.0 - beta2 ** t) + group["eps"]
                out[name] = (p.detach() + lr / (1.0 - beta1 ** t) * st["exp_avg"] / denom).clone()
        return out

    def step(self, k: int, idx: torch.Tensor, total: torch.Tensor, aux: dict) -> None:
        if k >= REFERENCE_STEPS:
            return
        r = self.run.readings
        if not self.trainer.model.use_svf_in_output:
            self._normalized(self._step_normalized())
        elif k:
            r["normalized"].append(None)
        parts = {n: float(v) for n, v in aux.items()}
        r["parts"].append(parts)
        r["losses"].append(float(total))
        r["fit_losses"].append(sum(parts[t] for t in checks.DATA_TERMS))
        r["batches"].append(idx.cpu().numpy())
        params = dict(self.trainer.model.named_parameters())
        self.before = {n: params[n].detach().clone() for n in checks.LOOP_STATE}
        if k == 0:
            state = self.trainer.optimizer.state
            r["grad_norms"] = {  # no state: the optimizer got no gradient
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
        r["valid_loss"] = float(losses["edc_loss"] + losses["edr_loss"])
        r["valid_batch"] = vidx.cpu().numpy()
        r["valid_masks_before"] = steps  # the EDC masks the epoch's steps drew
        r["valid_params"] = {n: p.detach().clone()
                             for n, p in self.trainer.model.named_parameters()}


def unit(run, observe=None) -> dict:
    """One epoch: {"rirs": real receivers stepped, "steps", "valid"}."""
    st = run.state
    trainer = st["trainer"]
    perm = st["train_idx"][st["order"].permutation(len(st["train_idx"]))]
    idx_mat = torch.as_tensor(np.stack(port.padded_batches(perm, st["bs"])), dtype=torch.long,
                              device=run.device)
    if trainer.model.use_svf_in_output:
        with run.span("normalize"):
            trainer._normalize_params()
        if observe is not None:
            observe.normalized()
    ep_total, ep_aux = 0.0, {}
    for k, idx in enumerate(idx_mat):
        with run.span("fit_step"):
            t0 = time.perf_counter()
            total, aux = trainer.fit_step(idx)
            if run.tracing:
                run.host_step_s.append(time.perf_counter() - t0)
        ep_total = ep_total + total
        ep_aux = {key: ep_aux.get(key, 0.0) + v for key, v in aux.items()}
        if observe is not None:
            observe.step(k, idx, total, aux)
    v_total, v_aux = 0.0, {}
    for j, vidx in enumerate(st["valid"]):
        with run.span("valid_step"):
            total, losses = trainer.valid_step(vidx, st["vbs"])
        if observe is not None:
            observe.valid(j, vidx, losses, int(idx_mat.shape[0]))
        v_total = v_total + total * len(vidx)
        v_aux = {key: v_aux.get(key, 0.0) + v * len(vidx) for key, v in losses.items()}
    with run.span("epoch_read"):
        row = [ep_total, *ep_aux.values()] + ([v_total, *v_aux.values()] if st["valid"] else [])
        torch.stack([torch.as_tensor(x, device=run.device) for x in row]).tolist()
    return {"rirs": len(st["train_idx"]), "steps": int(idx_mat.shape[0]),
            "valid": [len(v) for v in st["valid"]]}


def end_to_end(run, units, elapsed: float) -> dict:
    return {"train_rirs_per_s": {"value": sum(u["rirs"] for u in units) / elapsed,
                                 "unit": "rirs/s"}}


def attempts(run, units):
    """(training steps attempted, steps failed)."""
    return sum(u["steps"] for u in units), 0


def release(run) -> None:
    trainer = run.state.pop("trainer", None)
    if trainer is not None:
        trainer.graphs.clear()


def check(run) -> dict:
    r, st = run.readings, run.state
    reference = checks.ReferenceTraining(run.preset, st["grid"], st["weights"], r["batches"],
                                         run.seed, run.device, follow=r["normalized"]).run()
    reference["scales"] = checks.reference_scales(run.preset, st["grid"], r["norm_states"],
                                                  run.device)
    reference["valid_loss"] = checks.reference_valid_loss(run.preset, st["grid"], r, run.seed,
                                                          run.device)
    return checks.training_numbers(r, reference)
