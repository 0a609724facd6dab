"""The trainer's losses and gradients in the port against JAX's GFDNTrainer._losses.

Both trainers precompute their target features from the same synthetic
dataset (fs 8 kHz, nfft 2^14, the long decay times of torch_port_helpers),
and both evaluate one batch at the same (converted) parameters: SVF heads
with GEQ absorption and the losses of the full-band preset (EDC, EDR,
sparsity; the colorless spectral term, see below), and scalar heads with EDC
and EDR. With the EDC mask on, the test draws the mask as JAX's
``edc_loss_from_rir`` does from the step key and hands it to the port.
Bounds: the total loss and each term <= 1e-3 relative, every gradient leaf
<= 1e-2 relative L2. The scalar-head cases are in test_torch_trainer_scalar.py.

The colorless spectral term evaluates the LOSSLESS sub-FDNs, whose poles lie
on the unit circle: on |z| = 1 its value is set by a few bins next to a
pole, and float32 rounding of z^m (about 1e-4 in both packages, in different
directions) moves it by tens of percent (JAX against itself moves from
6.3e7 to 1.2e8 when z is nudged by one ulp; ROADMAP C). So the trainer test
runs with the spectral weight at 0, and the colorless terms (spectral and
sparsity, through ``sub_fdn_output`` and the Gauss-Jordan autograd
function) are held to JAX on their own, sampled just off the unit circle
(|z| = 1.001), where they are well conditioned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_room_dataset
from diffgfdn_torch.losses import amse_loss, sparsity_loss
from diffgfdn_torch.ops.unitary import orthogonal_from_skew
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
from diffgfdn_torch.utils.params import jax_grads_from_torch, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import gather_batch
from diffgfdn_tpu.losses import amse_loss as jax_amse_loss
from diffgfdn_tpu.losses import sparsity_loss as jax_sparsity_loss
from diffgfdn_tpu.models.gfdn import DiffGFDN as JaxDiffGFDN
from diffgfdn_tpu.ops.unitary import orthogonal_from_skew as jax_orthogonal_from_skew
from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer
from torch_port_helpers import jax_model_and_params, raw_config, rel_l2, rooms

NFFT = 2 ** 14
BATCH = 4
LOSS_TOL = 1e-3
GRAD_TOL = 1e-2
IDX = np.array([0, 3, 5, 7])


def trainer_config(tmp_path, svf: bool, mask: bool) -> dict:
    raw = raw_config(tmp_path, svf, nfft=NFFT, batch=BATCH)
    raw["trainer_config"].update(
        use_edc_mask=mask, use_colorless_loss=svf, use_asym_spectral_loss=svf,
        spectral_loss_weight=0.0,
    )
    return raw


def jax_mask(key, length: int) -> np.ndarray:
    """The mask JAX's edc_loss_from_rir draws from ``key``."""
    probs = jax.random.uniform(jax.random.fold_in(key, 0), (length,))
    return np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 1), probs), np.float32)


@pytest.mark.parametrize("mask", [False, True], ids=["svf", "svf_mask"])
def test_losses_and_gradients_match_jax(tmp_path, mask, record_property):
    check_losses_and_gradients(tmp_path, True, mask, record_property)


def check_losses_and_gradients(tmp_path, svf: bool, mask: bool, record_property) -> None:
    """The trainer test's body (the scalar-head cases run it from
    test_torch_trainer_scalar.py)."""
    raw = trainer_config(tmp_path, svf, mask)
    jax_room, port_room = rooms(tmp_path, svf, NFFT)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    jax_model, params = jax_model_and_params(jcfg, jax_room, BATCH)
    jtrainer = JaxGFDNTrainer(jax_model, jcfg.trainer_config, 1,
                              common_decay_times=jax_room.common_decay_times,
                              sample_rate=jcfg.sample_rate)
    arrays = jax_arrays(jax_room)
    jtrainer.precompute_target_features(arrays)
    jbatch = gather_batch(arrays, IDX)
    key = jax.random.PRNGKey(11)

    def total(p):
        losses = jtrainer._losses(p, jbatch, key)
        return sum(losses.values()), losses

    (ref_total, ref_losses), ref_grads = jax.value_and_grad(total, has_aux=True)(params)

    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                             device="cpu")
    load_jax_params(model, params)
    trainer = GFDNTrainer(model, cfg.trainer_config, 1,
                          common_decay_times=port_room.common_decay_times,
                          sample_rate=cfg.sample_rate, device="cpu")
    trainer.upload_arrays(arrays_from_room_dataset(port_room))
    edc_len = min(trainer.max_ir_len_samps, NFFT) - trainer.mixing_time_samps
    mask_values = torch.from_numpy(jax_mask(key, edc_len)) if mask else None
    tot, losses = trainer.loss_and_grads(trainer.gather(torch.from_numpy(IDX)), mask_values)

    assert sorted(losses) == sorted(ref_losses)
    loss_err = abs(float(tot) - float(ref_total)) / abs(float(ref_total))
    record_property("loss_rel", loss_err)
    assert loss_err <= LOSS_TOL
    for k, v in ref_losses.items():
        assert abs(float(losses[k]) - float(v)) <= LOSS_TOL * abs(float(v)), k
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(model)))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(grads) == len(flat_ref)
    errs = {jax.tree_util.keystr(path): rel_l2(grads[path], np.asarray(leaf))
            for path, leaf in flat_ref}
    record_property("worst_grad_rel_l2", max(errs.values()))
    for path, err in errs.items():
        assert err <= GRAD_TOL, (path, err)


def test_colorless_terms_match_jax_off_the_unit_circle(tmp_path, record_property):
    raw = trainer_config(tmp_path, True, False)
    jax_room, port_room = rooms(tmp_path, True, NFFT)
    jax_model, params = jax_model_and_params(JaxDiffGFDNConfig.model_validate(raw), jax_room,
                                             BATCH)
    z = (1.001 * np.exp(1j * np.linspace(0.0, np.pi, NFFT // 2 + 1))).astype(np.complex64)
    groups = jax_model.num_groups

    def jax_loss(p):
        h_out, _ = jax_model.apply(p, jnp.asarray(z), method=JaxDiffGFDN.sub_fdn_output)
        spectral = sum(jax_amse_loss(h_out[:, k], jnp.ones(h_out.shape[0])) for k in range(groups))
        m = p["params"]["feedback_loop"]["M"]
        return spectral + jax_sparsity_loss(jax_orthogonal_from_skew(m)[-1])

    ref, ref_grads = jax.value_and_grad(jax_loss)(params)

    model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
                             port_room.band_centre_hz, device="cpu")
    load_jax_params(model, params)
    h_out, _ = model.sub_fdn_output(torch.from_numpy(z))
    loss = sum(amse_loss(h_out[:, k], torch.ones(h_out.shape[0])) for k in range(groups))
    loss = loss + sparsity_loss(orthogonal_from_skew(model.feedback_loop.M)[-1])
    loss.backward()

    loss_err = abs(float(loss.detach()) - float(ref)) / abs(float(ref))
    record_property("loss_rel", loss_err)
    assert loss_err <= LOSS_TOL
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(model)))
    errs = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_grads):
        if path in grads:  # the io gains and M; the heads take no part
            errs[jax.tree_util.keystr(path)] = rel_l2(grads[path], np.asarray(leaf))
        else:
            assert not np.any(np.asarray(leaf)), jax.tree_util.keystr(path)
    record_property("worst_grad_rel_l2", max(errs.values()))
    assert len(errs) == 3
    for path, err in errs.items():
        assert err <= GRAD_TOL, (path, err)
