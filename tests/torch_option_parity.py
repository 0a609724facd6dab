"""Shared parity checks of the coupling, absorption, encoding and loss options
(tests/test_torch_{filter_coupling,absorption_options,meshgrid,loss_options}.py).

A narrow DiffGFDNVarReceiverPos config (torch_port_helpers.raw_config) with
the option's overrides is built in both packages, the JAX model's initial
parameters carried into the port, and each check runs both on the same
numpy inputs:

* :func:`step_errors`: H (the loop part, the early response taken off) and
  the trainer's losses and every gradient leaf on one gathered batch;
* :func:`adam_error`: one Adam step from the same parameters on JAX's
  gradients of that step, against optax (each parameter's update);
* :func:`served_errors`: ``InferDiffGFDN.rirs_at`` from a JAX checkpoint;
* :func:`time_domain_error`: ``make_time_domain_synthesis_fn`` against JAX's.
"""

import copy
from dataclasses import dataclass

import jax
import numpy as np
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_room_dataset
from diffgfdn_torch.inference import InferDiffGFDN, make_time_domain_synthesis_fn
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer, make_optimizer, param_labels
from diffgfdn_torch.utils.params import (
    flax_path,
    jax_grads_from_torch,
    jax_params_from_torch,
    load_jax_params,
    torch_state_from_jax,
)
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import gather_batch
from diffgfdn_tpu.inference import gfdn_inference as jinf
from diffgfdn_tpu.training import optim as jax_optim
from diffgfdn_tpu.training.checkpoints import save_checkpoint
from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer
from torch_port_helpers import edc_db, FS, jax_model_and_params, raw_config, rel_l2, rooms

NFFT = 2048  # the step checks
SERVE_NFFT = 4096  # serving and the time domain: RIRs longer than the 0.5 s EDC window
BATCH = 4
IDX = np.array([0, 3, 5, 7])
H_TOL = 1e-3  # H, the slice bound (C7)
LOSS_TOL = 1e-3  # the trainer's losses, relative
GRAD_TOL = 1e-2  # the trainer's gradients, relative L2, every leaf
UPDATE_TOL = 1e-6  # one Adam step, max abs difference of the updates
RIR_TOL = 1e-3  # served RIRs, relative L2
EDC_TOL_DB = 0.01  # served RIRs' EDC over 0.5 s
TD_TOL = 1e-4  # time domain against JAX: max abs error / peak
INPUTS = ("z_values", "listener_position", "norm_listener_position", "target_early_response",
          "source_position", "mesh_2d")


def merged(raw: dict, over: dict) -> dict:
    """``raw`` with each section of ``over`` merged into it (one level deep)."""
    out = copy.deepcopy(raw)
    for key, val in over.items():
        out[key] = {**(out.get(key) or {}), **val} if isinstance(val, dict) else val
    return out


@dataclass
class OptionModels:
    raw: dict
    jcfg: object
    jmodel: object
    params: dict
    cfg: DiffGFDNConfig
    model: torch.nn.Module
    jax_room: object
    port_room: object


def option_models(tmp_path, over: dict, svf: bool, nfft: int = NFFT, batch: int = BATCH,
                  rooms_hook=None) -> OptionModels:
    """Both packages' models of ``raw_config(svf)`` with ``over`` merged in,
    the JAX model's initial parameters loaded into the port's (whose state
    names and shapes must be exactly the ones they map to, and which map
    back to the same tree). ``rooms_hook`` edits both datasets first."""
    raw = merged(raw_config(tmp_path, svf, nfft=nfft, batch=batch), over)
    jax_room, port_room = rooms(tmp_path, svf, nfft)
    if rooms_hook is not None:
        rooms_hook(jax_room, port_room)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    jmodel, params = jax_model_and_params(jcfg, jax_room, batch)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                             device="cpu")
    mapped = torch_state_from_jax(params)
    assert ({k: tuple(v.shape) for k, v in mapped.items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})
    load_jax_params(model, params)
    # and back: the port writes the JAX checkpoint's tree, leaf for leaf
    back = dict(jax.tree_util.tree_leaves_with_path(jax_params_from_torch(model)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(back[path], np.asarray(leaf))
    return OptionModels(raw, jcfg, jmodel, params, cfg, model, jax_room, port_room)


def step_errors(m: OptionModels, idx: np.ndarray = IDX) -> dict:
    """H, the trainer's losses and gradients of one batch, port against JAX:
    {"h": rel L2, "losses": {name: rel}, "grads": {leaf: rel L2},
    "ref_grads": JAX's gradient tree}."""
    arrays = jax_arrays(m.jax_room)
    jtrainer = JaxGFDNTrainer(m.jmodel, m.jcfg.trainer_config, 1,
                              common_decay_times=m.jax_room.common_decay_times, sample_rate=FS)
    jtrainer.precompute_target_features(arrays)
    # device arrays: a numpy mesh cannot be indexed by traced indices
    jbatch = {k: jax.numpy.asarray(v) for k, v in gather_batch(arrays, idx).items()}
    key = jax.random.PRNGKey(11)
    inputs = {k: jbatch[k] for k in INPUTS if k in jbatch}

    def total(p):
        losses = jtrainer._losses(p, jbatch, key)
        h = m.jmodel.apply(p, inputs)  # (H, sub-FDN outputs) with the colorless loss
        return sum(losses.values()), (losses, h[0] if isinstance(h, tuple) else h)

    (ref_total, (ref_losses, h_ref)), ref_grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(m.params)

    trainer = GFDNTrainer(m.model, m.cfg.trainer_config, 1,
                          common_decay_times=m.port_room.common_decay_times, sample_rate=FS,
                          device="cpu")
    trainer.upload_arrays(arrays_from_room_dataset(m.port_room))
    batch = trainer.gather(torch.from_numpy(idx))
    with torch.no_grad():
        h = m.model(batch).numpy()
    direct = np.asarray(jbatch["target_early_response"])
    tot, losses = trainer.loss_and_grads(batch)
    assert sorted(losses) == sorted(ref_losses)
    # relative, or absolute for a term whose weight is 0
    loss_errs = {k: abs(float(losses[k]) - float(v)) / (abs(float(v)) or 1.0)
                 for k, v in ref_losses.items()}
    loss_errs["total"] = abs(float(tot) - float(ref_total)) / abs(float(ref_total))
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(m.model)))
    flat = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(grads) == len(flat)
    return {"h": rel_l2(h - direct, np.asarray(h_ref) - direct), "losses": loss_errs,
            "grads": {jax.tree_util.keystr(p): rel_l2(grads[p], np.asarray(v))
                      for p, v in flat},
            "ref_grads": ref_grads}


def assert_step(errs: dict, record_property) -> None:
    """Record and bound :func:`step_errors`' H, losses and gradients."""
    record_property("h_rel_l2", errs["h"])
    record_property("loss_rel", errs["losses"])
    record_property("worst_grad_rel_l2", max(errs["grads"].values()))
    assert errs["h"] <= H_TOL, errs["h"]
    assert max(errs["losses"].values()) <= LOSS_TOL, errs["losses"]
    for path, err in errs["grads"].items():
        assert err <= GRAD_TOL, (path, err)


def adam_error(m: OptionModels, grads: dict) -> float:
    """One Adam step of the port's optimizer and of optax on the same
    gradients (a flax tree) from the same parameters: the largest difference
    of the updates; the labels of every leaf must be JAX's."""
    labels = {"/".join(p.key for p in path): label for path, label in
              jax.tree_util.tree_leaves_with_path(jax_optim.label_params(m.params))}
    got = {"/".join(["params"] + flax_path(k)[0]): v for k, v in param_labels(m.model).items()}
    assert got == labels
    optimizer, _ = make_optimizer(m.cfg.trainer_config, m.model, 1)
    jopt = jax_optim.make_optimizer(m.jcfg.trainer_config, m.params, 1)
    updates, _ = jopt.update(grads, jopt.init(m.params), m.params)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(grads))
    flat_u = dict(jax.tree_util.tree_leaves_with_path(updates))
    before = {n: p.detach().clone() for n, p in m.model.named_parameters()}
    paths = {}
    for name, p in m.model.named_parameters():
        keys, axes = flax_path(name)
        paths[name] = (tuple(jax.tree_util.DictKey(k) for k in ["params"] + keys), axes)
        g = np.asarray(flat_g[paths[name][0]])
        p.grad = torch.tensor(np.ascontiguousarray(g if axes is None else g.T))
    optimizer.step()
    worst = 0.0
    for name, p in m.model.named_parameters():
        path, axes = paths[name]
        delta = (p.detach() - before[name]).numpy()
        ref = np.asarray(flat_u[path])
        worst = max(worst, float(np.abs((delta if axes is None else delta.T) - ref).max()))
    return worst


def served_errors(m: OptionModels, idx: np.ndarray = np.arange(6)) -> dict:
    """RIRs served from a JAX checkpoint of the initial parameters by both
    packages' ``InferDiffGFDN`` (a full batch and a padded one): relative L2
    and the largest EDC difference over 0.5 s."""
    save_checkpoint(m.jcfg.trainer_config.train_dir, -1, m.params)
    ref = jinf.InferDiffGFDN(m.jcfg, m.jax_room).rirs_at(idx, batch_size=BATCH)
    rirs = InferDiffGFDN(m.cfg, m.port_room, device="cpu").rirs_at(idx, batch_size=BATCH)
    assert rirs.shape == ref.shape == (len(idx), m.cfg.trainer_config.num_freq_bins)
    return {"rel_l2": rel_l2(rirs, ref),
            "edc_db": float(np.abs(edc_db(rirs) - edc_db(ref))[:, : int(0.5 * FS)].max())}


def time_domain_error(m: OptionModels, num_samples: int = SERVE_NFFT, mesh: bool = False
                      ) -> float:
    """Both packages' ``make_time_domain_synthesis_fn`` at the first BATCH
    receivers: max abs difference over JAX's peak."""
    idx = np.arange(BATCH)
    room = m.port_room
    batch = {"listener_position": room.receiver_position[idx].astype(np.float32),
             "norm_listener_position": room.norm_receiver_position[idx].astype(np.float32)}
    if mesh:
        batch["mesh_2d"] = room.mesh_2d.points.astype(np.float32)
    ref = np.asarray(jinf.make_time_domain_synthesis_fn(m.jmodel, m.params, num_samples)(
        dict(batch, z_values=np.ones(1, np.complex64))))
    rirs = make_time_domain_synthesis_fn(m.model, num_samples)(
        {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert rirs.shape == ref.shape == (BATCH, num_samples) and np.isfinite(rirs).all()
    return float(np.abs(rirs - ref).max() / np.abs(ref).max())
