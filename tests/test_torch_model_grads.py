"""Model-level gradient parity: DiffGFDNVarReceiverPos in the port against JAX.

The JAX model (XLA path on the CPU) is initialized, its parameters are
carried into the port, and both differentiate the same smooth real
functional of H, sum_f,b W |H - direct|^2 with a fixed random weight W, at
fs 8 kHz and nfft 2^14 (the long synthetic decay times of
torch_port_helpers). The port's gradients run through the autograd
functions of kernels/linalg.py and kernels/sos.py on the plain versions.
Every parameter leaf must agree with JAX to <= 2e-3 relative L2 (the H bound
of test_torch_models.py; all parameters are real, so no conjugation enters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.utils.params import jax_grads_from_torch, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset, gather_batch
from torch_port_helpers import jax_model_and_params, raw_config, rel_l2, rooms

NFFT = 2 ** 14
BATCH = 4
GRAD_TOL = 2e-3


def _batch(room, idx):
    batch = gather_batch(arrays_from_room_dataset(room), idx)
    keys = ("z_values", "listener_position", "norm_listener_position", "target_early_response")
    return {k: np.asarray(batch[k]) for k in keys}


@pytest.mark.parametrize("svf", [True, False], ids=["svf_heads", "scalar_heads"])
def test_parameter_gradients_match_jax(tmp_path, svf, record_property):
    raw = raw_config(tmp_path, svf, nfft=NFFT, batch=BATCH)
    jax_room, port_room = rooms(tmp_path, svf, NFFT)
    jax_model, params = jax_model_and_params(
        JaxDiffGFDNConfig.model_validate(raw), jax_room, BATCH
    )
    batch = _batch(jax_room, np.array([0, 2, 4, 8]))
    weight = np.random.RandomState(5).uniform(0.5, 1.5, (BATCH, NFFT // 2 + 1)).astype(np.float32)
    direct = batch["target_early_response"]

    def jax_loss(p):
        h = jax_model.apply(p, batch) - direct
        return jnp.sum(weight * (jnp.real(h) ** 2 + jnp.imag(h) ** 2))

    ref = jax.jit(jax.grad(jax_loss))(params)

    model = build_gfdn_model(
        DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
        port_room.band_centre_hz, device="cpu",
    )
    load_jax_params(model, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    h = model(tb) - tb["target_early_response"]
    torch.sum(torch.from_numpy(weight) * (h.real ** 2 + h.imag ** 2)).backward()
    grads = jax_grads_from_torch(model)

    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(flat) == len(flat_ref)
    errs = {jax.tree_util.keystr(path): rel_l2(flat[path], np.asarray(leaf))
            for path, leaf in flat_ref}
    record_property("worst_grad_rel_l2", max(errs.values()))
    for path, err in errs.items():
        assert err <= GRAD_TOL, (path, err)
