"""The directional trainer's sub-FDN terms against the JAX package on the
bins the port takes (ROADMAP C10): every bin for 4-line groups (ambi order
1), all but the DC bin for 9-line groups (order 2), where every lossless
loop is singular at z = 1. Bounds (C3's): the normalized io gains within the
model bound 2e-3 relative L2, the spectral and sparsity terms within 1e-3,
their gradients within 1e-2. The spectral term is held off the unit circle
(|z| = 1.001), where the sub-FDNs' poles do not sit on the grid (C2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.training.trainer import sub_fdn_bins
from diffgfdn_torch.utils.params import jax_grads_from_torch
from diffgfdn_tpu.losses import amse_loss as jax_amse_loss
from diffgfdn_tpu.losses import sparsity_loss as jax_sparsity_loss
from diffgfdn_tpu.models.gfdn import DiffGFDN as JaxDiffGFDN
from diffgfdn_tpu.ops.unitary import orthogonal_from_skew
from test_torch_directional_losses import _trainers, GRAD_TOL, IDX, LOSS_TOL
from test_torch_directional_losses import rooms  # noqa: F401 (the module fixture)
from torch_port_helpers import rel_l2

MODEL_TOL = 2e-3
OFF_CIRCLE = 1.001


def _io_gains(params):
    p = params["params"]
    return np.concatenate([np.asarray(p["input_gains"]), np.asarray(p["output_gains"])])


def _jax_sub_fdn_terms(jtrainer, params, z):
    """JAX's spectral and sparsity terms (``GFDNTrainer._losses``) of the
    sub-FDNs evaluated at the bins z."""
    cfg = jtrainer.cfg
    h, _ = jtrainer.model.apply(params, z, method=JaxDiffGFDN.sub_fdn_output)
    spectral = sum(cfg.spectral_loss_weight * jax_amse_loss(h[:, k], jnp.ones(h.shape[0]))
                   for k in range(h.shape[1]))
    ortho = orthogonal_from_skew(params["params"]["feedback_loop"]["M"])
    return spectral, cfg.sparsity_loss_weight * jax_sparsity_loss(ortho[-1])


@pytest.mark.parametrize("order", [1, 2], ids=["order1_all_bins", "order2_dc_skipped"])
def test_sub_fdn_terms_match_jax_on_the_bins_they_take(tmp_path, rooms, order,
                                                       record_property):
    """The per-step normalization and the colorless terms (spectral weight
    1, as the presets) against JAX's evaluated on the bins the port takes:
    z[1:] for 9-line groups (C10), every bin for 4-line groups. The
    normalization on the unit circle, where JAX's DC bin sets its scale at
    order 2; the spectral and sparsity terms and their gradients through
    the step's shared inverse at |z| = 1.001 (C2)."""
    jtrainer, params, trainer, _ = _trainers(tmp_path, rooms, order, False,
                                             spectral_loss_weight=1.0)
    z = trainer.data["z_values"]
    bins = slice(1, None) if order == 2 else slice(None)
    assert torch.equal(sub_fdn_bins(trainer.model, z), z[bins])

    # normalization on |z| = 1
    model = trainer.model
    gains0 = [g.detach().clone() for g in (model.input_gains, model.output_gains)]
    trainer._normalize_params()
    got = torch.cat([model.input_gains, model.output_gains]).detach().numpy()
    ref = _io_gains(jtrainer._normalize_params(params, {"z_values": jnp.asarray(z[bins].numpy())}))
    err = rel_l2(got, ref)
    record_property("normalized_gains_rel_l2", err)
    assert err <= MODEL_TOL
    if order == 2:  # JAX's normalization over every bin is set by the DC bin
        every = _io_gains(jtrainer._normalize_params(params, {"z_values": jnp.asarray(z.numpy())}))
        assert rel_l2(got, every) > 100 * MODEL_TOL
    with torch.no_grad():
        model.input_gains.copy_(gains0[0])
        model.output_gains.copy_(gains0[1])

    # the step's normalization and colorless terms off the circle
    zo = z * OFF_CIRCLE
    trainer.data["z_values"] = zo
    for p in model.parameters():
        p.grad = None
    inverse = trainer._normalize_params(keep_inverse=True)
    losses = trainer._losses(trainer.gather(torch.from_numpy(IDX)), sub_inverse=inverse)
    (losses["spectral_loss"] + losses["sparsity_loss"]).backward()
    jz = jnp.asarray(zo[bins].numpy())
    jparams = jtrainer._normalize_params(params, {"z_values": jz})
    gain_err = rel_l2(torch.cat([model.input_gains, model.output_gains]).detach().numpy(),
                      _io_gains(jparams))
    assert gain_err <= MODEL_TOL

    def terms(p):
        spectral, sparsity = _jax_sub_fdn_terms(jtrainer, p, jz)
        return spectral + sparsity, (spectral, sparsity)

    (_, (spectral, sparsity)), jgrads = jax.value_and_grad(terms, has_aux=True)(jparams)
    errs = {k: abs(float(losses[k].detach()) - float(v)) / abs(float(v))
            for k, v in (("spectral_loss", spectral), ("sparsity_loss", sparsity))}
    record_property("sub_fdn_terms_rel", max(errs.values()))
    assert float(spectral) > 0.0
    for k, e in errs.items():
        assert e <= LOSS_TOL, (k, e)
    grads = jax_grads_from_torch(model)["params"]
    ref_grads = jgrads["params"]
    grad_errs = {k: rel_l2(np.asarray(grads[k]), np.asarray(ref_grads[k]))
                 for k in ("input_gains", "output_gains")}
    grad_errs["M"] = rel_l2(np.asarray(grads["feedback_loop"]["M"]),
                            np.asarray(ref_grads["feedback_loop"]["M"]))
    record_property("worst_sub_fdn_grad_rel_l2", max(grad_errs.values()))
    for k, e in grad_errs.items():
        assert e <= GRAD_TOL, (k, e)
