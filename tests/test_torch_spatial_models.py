"""The common-slopes heads against the JAX package, from carried flax
parameters: the directional beamforming MLP with ``directional_amplitudes``
and the omni amplitude MLP. Forward within 1e-6 relative (max abs error over
max |JAX|), gradients of a weighted sum within 1e-5 relative L2 per leaf;
the flax trees round-trip exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.models.dnn import sigmoid
from diffgfdn_torch.models.spatial import build_analysis_matrix, directional_amplitudes
from diffgfdn_torch.utils.params import jax_grads_from_torch, jax_params_from_torch
from diffgfdn_tpu.models import dnn as jax_dnn
from diffgfdn_tpu.models import spatial as jax_spatial
from torch_port_helpers import cs_configs, cs_models, cs_raw_config, cs_room_path, cs_rooms
from torch_port_helpers import max_rel, rel_l2

FWD_TOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    return cs_rooms(cs_room_path(tmp_path_factory.mktemp("cs_models")))


def _heads(tmp_path, rooms, directional):
    jcfg, cfg = cs_configs(cs_raw_config(tmp_path, directional))
    return cs_models(jcfg, cfg, rooms[0]) + (cfg,)


def _inputs(room, n=24, seed=0):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(room.num_rec)[:n]
    pos = room.norm_receiver_position[idx].astype(np.float32)
    return pos, rng.randn(n, 12, 3).astype(np.float32), rng.randn(n, 3).astype(np.float32)


def test_sigmoid_rounds_as_jax():
    x = np.random.RandomState(1).randn(4096).astype(np.float32) * 6
    ref = np.asarray(jax_dnn.sigmoid(jnp.asarray(x)))
    assert max_rel(sigmoid(torch.from_numpy(x)).numpy(), ref) <= FWD_TOL


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
def test_flax_trees_round_trip(tmp_path, rooms, directional):
    _, params, model, _ = _heads(tmp_path, rooms, directional)
    back = jax_params_from_torch(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for (path, ref), got in zip(flat, jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(ref), got), path


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
def test_heads_forward_and_gradients_match_jax(tmp_path, rooms, directional, record_property):
    jax_room, room = rooms
    jmodel, params, model, _ = _heads(tmp_path, rooms, directional)
    pos, w_dir, w_omni = _inputs(room)
    analysis = build_analysis_matrix(room.ambi_order, room.sph_directions,
                                     jax_spatial.BeamformerType.MAX_DI)

    def jax_out(p):
        out = jmodel.apply(p, {"norm_listener_position": jnp.asarray(pos)})
        if directional:
            return jax_spatial.directional_amplitudes(jnp.asarray(analysis), out)
        return out

    weight = w_dir if directional else w_omni
    ref_out = np.asarray(jax_out(params))
    grads = jax.grad(lambda p: jnp.sum(jax_out(p) * weight))(params)

    out = model({"norm_listener_position": torch.from_numpy(pos)})
    if directional:
        out = directional_amplitudes(torch.from_numpy(analysis), out)
    assert out.shape == ref_out.shape
    fwd = max_rel(out.detach().numpy(), ref_out)
    torch.sum(out * torch.from_numpy(weight)).backward()
    port_grads = jax_grads_from_torch(model)
    errs = [rel_l2(g, np.asarray(r)) for g, r in zip(jax.tree_util.tree_leaves(port_grads),
                                                      jax.tree_util.tree_leaves(grads))]
    record_property("forward_max_rel", fwd)
    record_property("worst_grad_rel_l2", max(errs))
    assert fwd <= FWD_TOL
    assert max(errs) <= GRAD_TOL
