"""The common-slopes trainer against the JAX package: one step's loss (1e-5
relative) and gradients (1e-4 relative L2) from the same parameters and
batch, directional and omni; with the smoothness loss on, each loss term
and its gradients against JAX's step evaluated in float64 (ROADMAP C13);
one Adam step against optax (each update within 1e-6 absolute, as
``tests/test_torch_optim.py``); the StepLR(20 epochs) factor against
optax's schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffgfdn_torch.data import arrays_from_spatial_dataset
from diffgfdn_torch.training import collapse_amplitudes_to_omni, SpatialSamplingTrainer
from diffgfdn_torch.training.optim import make_single_lr_optimizer, step_decay_factor
from diffgfdn_torch.utils.params import flax_path, jax_grads_from_torch
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.training.spatial_trainer import (
    collapse_amplitudes_to_omni as jax_collapse,
    SpatialSamplingTrainer as JaxSpatialSamplingTrainer,
)
from torch_port_helpers import cs_configs, cs_models, cs_raw_config, cs_room_path, cs_rooms
from torch_port_helpers import CS_RESOLUTION_M, rel_l2

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-6
KEYS = ("norm_listener_position", "listener_position", "target_common_slope_amps")


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    return cs_rooms(cs_room_path(tmp_path_factory.mktemp("cs_trainer")))


def trainers(tmp_path, rooms, directional, use_smoothness_loss=False, **raw):
    jax_room, room = rooms
    if not directional:
        jax_room, room = jax_collapse(jax_room), collapse_amplitudes_to_omni(room)
    jcfg, cfg = cs_configs({**cs_raw_config(tmp_path / "train", directional), **raw})
    jmodel, params, model = cs_models(jcfg, cfg, jax_room)
    jtrainer = JaxSpatialSamplingTrainer(jmodel, jcfg, jax_room,
                                         use_smoothness_loss=use_smoothness_loss,
                                         grid_resolution_m=CS_RESOLUTION_M)
    trainer = SpatialSamplingTrainer(model, cfg, room, use_smoothness_loss=use_smoothness_loss,
                                     grid_resolution_m=CS_RESOLUTION_M, device="cpu")
    trainer.upload_arrays(arrays_from_spatial_dataset(room))
    return jtrainer, params, trainer, jax_arrays(jax_room)


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
def test_step_loss_and_gradients_match_jax(tmp_path, rooms, directional, record_property):
    jtrainer, params, trainer, arrays = trainers(tmp_path, rooms, directional)
    idx = np.random.RandomState(7).permutation(arrays.num_items)[:16]
    batch = {k: jnp.asarray(np.asarray(getattr(arrays, k)[idx], np.float32)) for k in KEYS}
    (ref, _), grads = jax.value_and_grad(jtrainer._loss_fn, has_aux=True)(params, batch)
    loss = trainer.loss_and_grads(trainer.gather(torch.from_numpy(idx)))
    loss_rel = abs(loss.item() - float(ref)) / abs(float(ref))
    errs = [rel_l2(g, np.asarray(r)) for g, r in zip(
        jax.tree_util.tree_leaves(jax_grads_from_torch(trainer.model)),
        jax.tree_util.tree_leaves(grads))]
    record_property("loss_rel", loss_rel)
    record_property("worst_grad_rel_l2", max(errs))
    assert loss_rel <= LOSS_TOL
    assert max(errs) <= GRAD_TOL


def test_step_with_smoothness_loss_matches_jax_in_float64(tmp_path, rooms, record_property):
    """The directional step with the smoothness term on: each term (the EDC
    loss and 1e-4 x the smoothness loss, whose positions come from
    ``find_position_idx``) and its gradients against JAX's trainer evaluated
    in float64, where JAX's expanded squared distance has no rounding on its
    diagonal (ROADMAP C13); the float32 gap of JAX's own term is recorded.

    The pairwise differences cancel the output layer's bias, so the
    smoothness term's gradient there is 0 in exact arithmetic: that leaf is
    held to 1e-4 of the whole gradient's norm, every other leaf to 1e-4 of
    its own."""
    jtrainer, params, trainer, arrays = trainers(tmp_path, rooms, True, use_smoothness_loss=True)
    idx = np.random.RandomState(7).permutation(arrays.num_items)[:16]
    batch = {k: np.asarray(getattr(arrays, k)[idx], np.float32) for k in KEYS}
    f32 = float(jtrainer._losses(params, batch)["smoothness_loss"])
    with jax.enable_x64(True):
        params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
        batch64 = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        ref = {}
        for term in ("edc_loss", "smoothness_loss"):
            val, grads = jax.value_and_grad(
                lambda p, t=term: jtrainer._losses(p, batch64)[t])(params64)
            ref[term] = (float(val), {jax.tree_util.keystr(k): np.asarray(g)
                                      for k, g in jax.tree_util.tree_leaves_with_path(grads)})
    dense = sorted(k for k in params["params"]["MLP_0"] if k.startswith("Dense_"))
    out_bias = jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k)
                                          for k in ("params", "MLP_0", dense[-1], "bias")))
    losses = trainer._losses(trainer.gather(torch.from_numpy(idx)))
    assert sorted(losses) == sorted(ref)
    for term, out in losses.items():
        val, grads = ref[term]
        for p in trainer.model.parameters():
            p.grad = None
        out.backward(retain_graph=True)
        loss_rel = abs(out.item() - val) / abs(val)
        whole = np.sqrt(sum(np.sum(r ** 2) for r in grads.values()))
        got = {jax.tree_util.keystr(k): np.asarray(g) for k, g in
               jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(trainer.model))}
        assert sorted(got) == sorted(grads)
        errs = [rel_l2(got[k], r) if not (term == "smoothness_loss" and k == out_bias)
                else float(np.linalg.norm(got[k] - r) / whole) for k, r in grads.items()]
        record_property(f"{term}_rel_vs_jax_f64", loss_rel)
        record_property(f"{term}_worst_grad_rel_l2_vs_jax_f64", max(errs))
        assert loss_rel <= LOSS_TOL, (term, loss_rel)
        assert max(errs) <= GRAD_TOL, (term, max(errs))
    val = ref["smoothness_loss"][0]
    record_property("jax_f32_smoothness_rel_vs_jax_f64", abs(f32 - val) / abs(val))


def test_adam_step_matches_optax_across_the_step_decay(tmp_path, rooms, record_property):
    """Identical gradients, one step per epoch: steps 0..20, the last after
    the 20-epoch boundary."""
    _, params, trainer, _ = trainers(tmp_path, rooms, True)
    lr = 5e-3
    optimizer, scheduler = make_single_lr_optimizer(trainer.model, lr, 1, 20)
    jopt = optax.adam(optax.exponential_decay(lr, transition_steps=20, decay_rate=0.1,
                                              staircase=True))
    jstate = jopt.init(params)
    rng = np.random.RandomState(0)
    worst = 0.0
    for _ in range(21):
        grads = jax.tree_util.tree_map(lambda x: rng.randn(*np.shape(x)).astype(np.float32),
                                       params)
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(grads))
        flat_u = dict(jax.tree_util.tree_leaves_with_path(updates))
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        for name, p in trainer.model.named_parameters():
            keys, transpose = flax_path(name)
            g = torch.from_numpy(np.asarray(flat_g[tuple(jax.tree_util.DictKey(k)
                                                         for k in ["params"] + keys)]))
            p.grad = g.T.contiguous() if transpose else g
        optimizer.step()
        scheduler.step()
        for name, p in trainer.model.named_parameters():
            keys, transpose = flax_path(name)
            ref = np.asarray(flat_u[tuple(jax.tree_util.DictKey(k) for k in ["params"] + keys)])
            got = (p.detach() - before[name]).numpy()
            got = got.T if transpose else got
            worst = max(worst, float(np.abs(got - ref).max()))
    record_property("max_update_abs_diff", worst)
    assert worst <= UPDATE_TOL


@pytest.mark.parametrize("steps_per_epoch", [1, 4, 7])
def test_step_decay_factor_equals_optax_at_the_20_epoch_boundary(steps_per_epoch):
    sched = optax.exponential_decay(1.0, transition_steps=20 * steps_per_epoch, decay_rate=0.1,
                                    staircase=True)
    for count in (0, 20 * steps_per_epoch - 1, 20 * steps_per_epoch,
                  40 * steps_per_epoch - 1, 40 * steps_per_epoch):
        got = step_decay_factor(count, steps_per_epoch, step_size_epochs=20)
        assert got == pytest.approx(float(sched(count)), rel=1e-6), count
    # the GFDN trainers keep their 10-epoch decay
    assert step_decay_factor(10 * steps_per_epoch, steps_per_epoch) == pytest.approx(0.1)


def test_fit_indexed_schedules_the_20_epoch_decay(tmp_path, rooms):
    """The trainer's own optimizer: one Adam group at the config's lr, the
    factor dropping at 20 epochs of its padded batch count."""
    _, _, trainer, _ = trainers(tmp_path, rooms, True, max_epochs=0)
    room = rooms[1]
    train_idx = np.arange(40)
    trainer.fit_indexed(arrays_from_spatial_dataset(room), train_idx)
    steps = -(-len(train_idx) // trainer.cfg.batch_size)
    assert len(trainer.optimizer.param_groups) == 1
    assert trainer.optimizer.param_groups[0]["lr"] == trainer.cfg.lr
    lam = trainer.scheduler.lr_lambdas[0]
    assert lam(20 * steps - 1) == 1.0 and lam(20 * steps) == pytest.approx(0.1)
