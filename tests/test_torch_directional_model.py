"""DiffDirectionalFDNVarReceiverPos against the JAX package on the CPU.

Both packages build the model as their directional solvers do (the analysis
matrix designed for the spatial dataset's directions); the port loads the
JAX model's flax parameters. Bounds (ROADMAP C3's model bounds): the
beamformer MLP within 1e-6; the transposed drive, the SH responses H
(B, L, F) within 2e-3 relative L2 (z ** m rounds
differently in the two packages, C7). The lossless sub-FDN outputs are
compared just off the unit circle (|z| = 1.001), where their poles do not
sit on the grid (C2), within the same bound. The gradients are in
``test_torch_directional_grads.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.models import DiffDirectionalFDNVarReceiverPos
from diffgfdn_torch.models.dnn import MLPSkipConnections
from diffgfdn_torch.models.spatial import DirectionalBeamformerWeightsMLP, normalise_weights
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.utils.params import jax_params_from_torch, load_jax_params
from diffgfdn_torch.utils.params import torch_state_from_jax
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.models.gfdn import DiffGFDN as JaxDiffGFDN
from diffgfdn_tpu.models.spatial import (
    DirectionalBeamformerWeightsMLP as JaxBeamformerMLP,
    normalise_weights as jax_normalise_weights,
)
from torch_port_helpers import (
    directional_raw_config,
    jax_directional_model_and_params,
    rel_l2,
    spatial_rooms,
)

BATCH = 4
NBINS = 513
MODEL_TOL = 2e-3
MLP_TOL = 1e-6


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    return spatial_rooms(tmp_path_factory.mktemp("dir_model"))


_JAX_MODELS = {}


def _models(tmp_path, rooms, order):
    """(JAX model, its params, the port's model with those params); the JAX
    model of an order is built once per module."""
    raw = directional_raw_config(tmp_path, order, batch=BATCH)
    if order not in _JAX_MODELS:
        _JAX_MODELS[order] = jax_directional_model_and_params(
            JaxDiffGFDNConfig.model_validate(raw), rooms[0], BATCH)
    jax_model, params = _JAX_MODELS[order]
    port_room = rooms[1]
    model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
                             port_room.band_centre_hz, variant="directional", device="cpu",
                             desired_directions=port_room.desired_directions)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


def _batch(rooms, radius: float = 1.0):
    pos = rooms[1].norm_receiver_position[[0, 7, 19, 40]].astype(np.float32)
    z = (radius * np.exp(1j * np.linspace(0.0, np.pi, NBINS))).astype(np.complex64)
    return {"z_values": z, "listener_position": pos * 10.0, "norm_listener_position": pos}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "plain_mlp"])
def test_beamformer_mlp_matches_flax(skip, record_property):
    rng = np.random.RandomState(4)
    x = {"norm_listener_position": rng.rand(6, 3).astype(np.float32)}
    mod = JaxBeamformerMLP(num_groups=3, ambi_order=2, num_fourier_features=5,
                           num_hidden_layers=3, num_neurons=24, use_skip_connections=skip)
    params = mod.init(jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in x.items()})
    port = DirectionalBeamformerWeightsMLP(3, 2, 5, 3, 24, use_skip_connections=skip)
    port.load_state_dict(torch_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    for normalise in (False, True):
        ref = np.asarray(mod.apply(params, {k: jnp.asarray(v) for k, v in x.items()},
                                   normalise=normalise))
        with torch.no_grad():
            got = port(xt, normalise=normalise).numpy()
        assert got.shape == ref.shape == (6, 3, 9)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        record_property(f"max_rel_normalise{normalise}", err)
        assert err <= MLP_TOL
    assert isinstance(getattr(port, "skip_mlp" if skip else "mlp"), torch.nn.Module)
    assert (isinstance(port.skip_mlp, MLPSkipConnections)) if skip else not hasattr(port, "skip_mlp")
    w = np.random.RandomState(1).randn(5, 3, 9).astype(np.float32)
    np.testing.assert_allclose(normalise_weights(torch.from_numpy(w)).numpy(),
                               np.asarray(jax_normalise_weights(jnp.asarray(w))), rtol=1e-6)


@pytest.mark.parametrize("order", [1, 2])
def test_parameter_tree_round_trips(tmp_path, rooms, order):
    """The directional model's parameters (residual blocks and LayerNorms
    of sh_output_scalars included) carry over to the flax tree and back."""
    jax_model, params, model = _models(tmp_path, rooms, order)
    ref = jax.tree_util.tree_map(np.asarray, params)
    back = jax_params_from_torch(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(got, want)
    assert model.analysis_matrix.shape == (12, (order + 1) ** 2)
    np.testing.assert_array_equal(model.analysis_matrix.numpy(), jax_model.analysis_matrix)


@pytest.mark.parametrize("order", [1, 2])
def test_transposed_drive_matches_jax(tmp_path, rooms, order, record_property):
    """q = P(z)^T b through the LU solve on the transposed blocks (B5, and
    B6 behind it) against the JAX drive, and against the untransposed one."""
    jax_model, params, model = _models(tmp_path, rooms, order)
    z = _batch(rooms)["z_values"]

    def jax_drive(mdl, zz, transpose):
        return mdl.feedback_loop.drive(zz, mdl.input_gains[:, 0], transpose=transpose)

    fl = model.feedback_loop
    for transpose in (True, False):
        ref = np.asarray(jax_model.apply(params, jnp.asarray(z), transpose,
                                         method=jax_drive))
        with torch.no_grad():
            got = fl.drive(torch.from_numpy(z), model.input_gains[:, 0], transpose=transpose)
        err = rel_l2(got.numpy(), ref)
        record_property(f"rel_l2_transpose{transpose}", err)
        assert got.shape == (NBINS, model.num_delay_lines) and err <= MODEL_TOL
    with torch.no_grad():
        m = fl.loop_matrix_blocks(torch.from_numpy(z))
        b = model.input_gains[:, 0].to(torch.complex64).reshape(3, 1, -1)
        direct = torch.linalg.solve(m.transpose(-1, -2), b.expand(3, NBINS, -1)[..., None])
    q = fl.drive(torch.from_numpy(z), model.input_gains[:, 0], transpose=True).detach()
    assert rel_l2(q.numpy(), direct[..., 0].transpose(0, 1).reshape(NBINS, -1).numpy()) <= 1e-5


@pytest.mark.parametrize("order", [1, 2])
def test_directional_forward_matches_jax(tmp_path, rooms, order, record_property):
    jax_model, params, model = _models(tmp_path, rooms, order)
    batch = _batch(rooms)
    h_ref, _ = jax_model.apply(params, _jnp(batch))
    with torch.no_grad():
        h = model(_torch(batch))
    assert h.shape == (BATCH, (order + 1) ** 2, NBINS) and h.dtype == torch.complex64
    err = rel_l2(h.numpy(), np.asarray(h_ref))
    record_property("h_rel_l2", err)
    assert err <= MODEL_TOL
    # the directional response through the analysis matrix
    d_ref = jax_model.apply(params, h_ref, method=type(jax_model).directional_response)
    with torch.no_grad():
        d = model.directional_response(h)
    assert d.shape == (BATCH, 12, NBINS) and rel_l2(d.numpy(), np.asarray(d_ref)) <= MODEL_TOL
    # the lossless sub-FDNs just off the unit circle
    z_off = _batch(rooms, radius=1.001)["z_values"]
    ref_out, ref_per_del = jax_model.apply(params, jnp.asarray(z_off),
                                           method=JaxDiffGFDN.sub_fdn_output)
    with torch.no_grad():
        out, per_del = model.sub_fdn_output(torch.from_numpy(z_off))
        shared = model.sub_fdn_output(torch.from_numpy(z_off),
                                      model.sub_fdn_inverse(torch.from_numpy(z_off)))
    for got, ref in ((out, ref_out), (per_del, ref_per_del)):
        err = rel_l2(got.numpy(), np.asarray(ref))
        record_property("sub_fdn_rel_l2", err)
        assert got.shape == ref.shape and err <= MODEL_TOL
    assert torch.equal(shared[0], out) and torch.equal(shared[1], per_del)


def test_directional_model_refuses_mismatched_lines():
    with pytest.raises(ValueError, match="ambisonic channels"):
        DiffDirectionalFDNVarReceiverPos(sample_rate=8000.0, num_groups=3,
                                         delays=list(range(100, 112)), gains=np.ones(12) * 0.9,
                                         ambi_order=2)
