"""Gradients of DiffDirectionalFDNVarReceiverPos against the JAX package on the CPU.

Every parameter's gradient of a real loss of the SH responses H and of the
sub-FDN outputs just off the unit circle, through B6 (the transposed
drive's backward) and B2 (the sub-FDN inverse's), within ROADMAP C3's model
bound of 2e-3 relative L2 per leaf, from the same flax parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.utils.params import jax_grads_from_torch
from diffgfdn_tpu.models.gfdn import DiffGFDN as JaxDiffGFDN
from test_torch_directional_model import _batch, _jnp, _models, _torch, BATCH, MODEL_TOL, NBINS
from test_torch_directional_model import rooms  # noqa: F401 (the module fixture)
from torch_port_helpers import rel_l2


@pytest.mark.parametrize("order", [1, 2])
def test_directional_gradients_match_jax(tmp_path, rooms, order, record_property):
    """Every parameter's gradient of a real loss of H and of the off-circle
    sub-FDN outputs: through B6 (the transposed drive's backward) and B2."""
    jax_model, params, model = _models(tmp_path, rooms, order)
    batch = _batch(rooms)
    z_off = _batch(rooms, radius=1.001)["z_values"]
    rng = np.random.RandomState(order)
    w = (rng.randn(BATCH, (order + 1) ** 2, NBINS)
         + 1j * rng.randn(BATCH, (order + 1) ** 2, NBINS)).astype(np.complex64)

    def jax_loss(p):
        h, _ = jax_model.apply(p, _jnp(batch))
        sub, _ = jax_model.apply(p, jnp.asarray(z_off), method=JaxDiffGFDN.sub_fdn_output)
        return jnp.sum(jnp.abs(h * w) ** 2) + 1e-3 * jnp.sum(jnp.abs(sub) ** 2)

    ref = jax.jit(jax.grad(jax_loss))(params)
    h = model(_torch(batch))
    sub, _ = model.sub_fdn_output(torch.from_numpy(z_off))
    loss = (torch.sum(torch.abs(h * torch.from_numpy(w)) ** 2)
            + 1e-3 * torch.sum(torch.abs(sub) ** 2))
    loss.backward()
    got = jax_grads_from_torch(model)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
        np.asarray, ref))[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_ref)
    worst = max(rel_l2(flat_got[k], v) for k, v in flat_ref.items())
    record_property("worst_grad_rel_l2", worst)
    assert worst <= MODEL_TOL
