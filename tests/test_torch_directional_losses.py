"""The directional losses and the directional trainer's step against the JAX package.

Inputs come from one synthetic spatial dataset (fs 8 kHz, 44 receivers,
decay times of 0.2-0.3 s, so nfft 4096) and the same flax parameters. Bounds
(ROADMAP C3's trainer bounds): each loss term and the total within 1e-3
relative, every gradient leaf within 1e-2 relative L2, one Adam step within
1e-6 of optax. With the EDC mask on, JAX's mask (drawn from the step key)
is handed to the port. The colorless spectral term runs at weight 0: on
|z| = 1 it is set by the poles of the lossless sub-FDNs and cannot be held
to JAX (C2); its terms are held off the circle in
test_torch_directional_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_spatial_dataset
from diffgfdn_torch.losses import (
    directional_edc_loss,
    directional_edc_loss_from_sh,
    make_decay_envelopes,
)
from diffgfdn_torch.training import build_gfdn_model, DirectionalGFDNTrainer, make_optimizer
from diffgfdn_torch.utils.params import flax_path, jax_grads_from_torch, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import gather_batch
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.losses.gfdn import directional_edc_loss as jax_directional_edc_loss
from diffgfdn_tpu.losses.gfdn import (
    directional_edc_loss_from_sh as jax_directional_edc_loss_from_sh,
)
from diffgfdn_tpu.losses.spatial import make_decay_envelopes as jax_make_decay_envelopes
from diffgfdn_tpu.ops.basic import ms_to_samps
from diffgfdn_tpu.training import optim as jax_optim
from diffgfdn_tpu.training.trainer import DirectionalGFDNTrainer as JaxDirectionalGFDNTrainer
from test_torch_trainer import jax_mask
from torch_port_helpers import (
    directional_raw_config,
    jax_directional_model_and_params,
    rel_l2,
    spatial_rooms,
)

BATCH = 4
IDX = np.array([0, 9, 21, 40])
LOSS_TOL = 1e-3
GRAD_TOL = 1e-2
UPDATE_TOL = 1e-6


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    return spatial_rooms(tmp_path_factory.mktemp("dir_losses"), decay_times=(0.2, 0.3, 0.25))


def _envelopes(room, cfg):
    cdt = np.asarray(room.common_decay_times)
    return cdt.reshape(-1)[: cfg.num_groups], ms_to_samps(float(np.max(cdt)) * 1e3,
                                                          cfg.sample_rate)


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "mask"])
def test_directional_edc_losses_match_jax(mask, record_property):
    rng = np.random.RandomState(3)
    f, lines, dirs = 2049, 9, 12
    h = (rng.randn(3, lines, f) + 1j * rng.randn(3, lines, f)).astype(np.complex64) * np.exp(
        -np.arange(f) / 400.0).astype(np.float32)
    a = rng.randn(dirs, lines).astype(np.float32)
    amps = rng.rand(3, dirs, 3).astype(np.float32)
    env = np.array(jax_make_decay_envelopes(np.array([0.2, 0.3, 0.25]), 3000, 8000.0))
    np.testing.assert_array_equal(
        make_decay_envelopes(np.array([0.2, 0.3, 0.25]), 3000, 8000.0).numpy(), env)
    key = jax.random.PRNGKey(5)
    length = min(2000 + 160, 4096) - 160
    mask_values = torch.from_numpy(jax_mask(key, length)) if mask else None
    ref = float(jax_directional_edc_loss_from_sh(
        jnp.asarray(h), a, jnp.asarray(amps), jnp.asarray(env), 160, 2000,
        mask_key=key if mask else None))
    got = float(directional_edc_loss_from_sh(
        torch.from_numpy(h), torch.from_numpy(a), torch.from_numpy(amps), torch.from_numpy(env),
        160, 2000, mask_values))
    # the same loss fed the directional responses (B, J, F)
    hd = np.einsum("jl,blf->bjf", a, h)
    ref_d = float(jax_directional_edc_loss(jnp.asarray(hd), jnp.asarray(amps), jnp.asarray(env),
                                           160, 2000, mask_key=key if mask else None))
    got_d = float(directional_edc_loss(torch.from_numpy(hd), torch.from_numpy(amps),
                                       torch.from_numpy(env), 160, 2000, mask_values))
    errs = [abs(got - ref) / abs(ref), abs(got_d - ref_d) / abs(ref_d)]
    record_property("loss_rel", max(errs))
    assert max(errs) <= LOSS_TOL
    assert abs(got - got_d) <= LOSS_TOL * abs(got_d)


_JAX_MODELS = {}


def _trainers(tmp_path, rooms, order, mask, spectral_loss_weight=0.0):
    """(JAX trainer, its params, the port's trainer with those params, the
    port's config); the JAX model of an order is built once per module."""
    raw = directional_raw_config(tmp_path, order, batch=BATCH, use_edc_mask=mask,
                                 spectral_loss_weight=spectral_loss_weight)
    jroom, room = rooms
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    if order not in _JAX_MODELS:
        _JAX_MODELS[order] = jax_directional_model_and_params(jcfg, jroom, BATCH)
    jax_model, params = _JAX_MODELS[order]
    times, length = _envelopes(jroom, jcfg)
    jtrainer = JaxDirectionalGFDNTrainer(
        jax_model, jcfg.trainer_config, 1, common_decay_times=jroom.common_decay_times,
        sample_rate=jcfg.sample_rate,
        directional_envelopes=np.asarray(jax_make_decay_envelopes(times, length, jcfg.sample_rate)))
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                             variant="directional", device="cpu",
                             desired_directions=room.desired_directions)
    load_jax_params(model, params)
    trainer = DirectionalGFDNTrainer(
        model, cfg.trainer_config, 1, common_decay_times=room.common_decay_times,
        sample_rate=cfg.sample_rate, device="cpu",
        directional_envelopes=make_decay_envelopes(times, length, cfg.sample_rate))
    trainer.upload_arrays(arrays_from_spatial_dataset(room))
    return jtrainer, params, trainer, cfg


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "mask"])
def test_trainer_losses_and_gradients_match_jax(tmp_path, rooms, mask, record_property):
    """Ambi order 1 (4 lines a group); order 2 is in test_torch_directional_step.py."""
    check_trainer_losses_and_gradients(tmp_path, rooms, 1, mask, record_property)


def check_trainer_losses_and_gradients(tmp_path, rooms, order, mask, record_property):
    """The directional trainer's losses and gradients against JAX's
    DirectionalGFDNTrainer._losses on one batch."""
    jtrainer, params, trainer, _ = _trainers(tmp_path, rooms, order, mask)
    jbatch = gather_batch(jax_arrays(rooms[0]), IDX)
    key = jax.random.PRNGKey(11)

    def total(p):
        losses = jtrainer._losses(p, jbatch, key)
        return sum(losses.values()), losses

    (ref_total, ref_losses), ref_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    batch = trainer.gather(torch.from_numpy(IDX))
    length = trainer.edc_mask_length(batch["z_values"].shape[0])
    assert length == trainer.max_ir_len_samps  # the EDC window fits nfft here
    mask_values = torch.from_numpy(jax_mask(key, length)) if mask else None
    tot, losses = trainer.loss_and_grads(batch, mask_values)

    assert sorted(losses) == sorted(ref_losses) == ["edc_loss", "sparsity_loss", "spectral_loss"]
    for k, v in ref_losses.items():
        assert abs(float(losses[k]) - float(v)) <= LOSS_TOL * abs(float(v)), k
    loss_err = abs(float(tot) - float(ref_total)) / abs(float(ref_total))
    record_property("loss_rel", loss_err)
    assert loss_err <= LOSS_TOL
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(trainer.model)))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(grads) == len(flat_ref)
    errs = {jax.tree_util.keystr(p): rel_l2(grads[p], np.asarray(leaf)) for p, leaf in flat_ref}
    record_property("worst_grad_rel_l2", max(errs.values()))
    for path, err in errs.items():
        assert err <= GRAD_TOL, (path, err)


def test_one_adam_step_matches_optax(tmp_path, rooms, record_property):
    """The directional model's parameter groups (the SH MLP under "other",
    the io gains under "io") and one Adam step from the same gradients."""
    jtrainer, params, trainer, cfg = _trainers(tmp_path, rooms, 2, False)
    jcfg = JaxDiffGFDNConfig.model_validate(directional_raw_config(tmp_path, 2, batch=BATCH))
    model = trainer.model
    optimizer, scheduler = make_optimizer(cfg.trainer_config, model, 1)
    assert {g["label"] for g in optimizer.param_groups} == {"io", "other"}
    jopt = jax_optim.make_optimizer(jcfg.trainer_config, params, 1)
    rng = np.random.RandomState(2)
    grads = jax.tree_util.tree_map(lambda x: rng.randn(*np.shape(x)).astype(np.float32), params)
    updates, _ = jopt.update(grads, jopt.init(params), params)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(grads))
    flat_u = dict(jax.tree_util.tree_leaves_with_path(updates))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for name, p in model.named_parameters():
        keys, transpose = flax_path(name)
        g = torch.from_numpy(np.asarray(flat_g[tuple(jax.tree_util.DictKey(k)
                                                     for k in ["params"] + keys)]))
        p.grad = g.T.contiguous() if transpose else g
    optimizer.step()
    scheduler.step()
    worst = 0.0
    for name, p in model.named_parameters():
        keys, transpose = flax_path(name)
        ref = np.asarray(flat_u[tuple(jax.tree_util.DictKey(k) for k in ["params"] + keys)])
        got = (p.detach() - before[name]).numpy()
        worst = max(worst, float(np.abs((got.T if transpose else got) - ref).max()))
    record_property("max_update_abs_diff", worst)
    assert worst <= UPDATE_TOL
    assert len(before) == len(jax.tree_util.tree_leaves(params))
