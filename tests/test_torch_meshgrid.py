"""Meshgrid position encoding (ROADMAP A4) in the port against the JAX package.

``encoding_type: meshgrid``: a head's MLP reads the one-hot floor-plan mesh
(each point's x, y and a 1 at the point nearest each position; input width
3), runs over all mesh points, and each position takes its nearest point's
output. The dataset's mesh (``mesh_2d``) is uploaded once, as a shared key.
Checked against JAX:

* ``models/dnn.one_hot_mesh_encoding`` on JAX's fixtures
  (tests/test_meshgrid_and_trained_inference.py): equal;
* JAX's meshgrid scalar-head model fixture (6 lines at 8 kHz, a 1 x 16 MLP,
  50 random mesh points): H within 1e-3 relative L2;
* the narrow config with meshgrid SVF heads: H 1e-3 relative L2, the
  trainer's losses 1e-3 and gradients 1e-2 (the first layer's (16, 3)
  kernel among them), one Adam step 1e-6.

Serving, the time domain and the source heads: test_torch_meshgrid_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffgfdn_torch.config.schema import FeatureEncodingType
from diffgfdn_torch.models import DiffGFDNVarReceiverPos
from diffgfdn_torch.models.dnn import one_hot_mesh_encoding
from diffgfdn_torch.utils.params import load_jax_params
from diffgfdn_tpu.config.schema import FeatureEncodingType as JaxFeatureEncodingType
from diffgfdn_tpu.models import DiffGFDNVarReceiverPos as JaxDiffGFDNVarReceiverPos
from diffgfdn_tpu.models import one_hot_mesh_encoding as jax_one_hot_mesh_encoding
from diffgfdn_tpu.ops.absorption import decay_times_to_gain_per_sample
from diffgfdn_tpu.ops.basic import get_frequency_samples
from torch_option_parity import (
    adam_error,
    assert_step,
    H_TOL,
    option_models,
    step_errors,
    UPDATE_TOL,
)
from torch_port_helpers import rel_l2

MESH_SVF = {"output_filter_config": {"encoding_type": "meshgrid"}}


def test_one_hot_mesh_encoding_equals_jax():
    mesh = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], np.float32)
    rec = np.array([[0.9, 0.95, 1.5]], np.float32)
    rng = np.random.RandomState(0)
    mesh50 = rng.rand(50, 2).astype(np.float32) * 5
    rec50 = np.concatenate([mesh50[:4] + 0.01, np.full((4, 1), 1.5, np.float32)], axis=1)
    for m, r in ((mesh, rec), (mesh50, rec50)):
        got = one_hot_mesh_encoding(torch.from_numpy(m), torch.from_numpy(r))
        want = jax_one_hot_mesh_encoding(jnp.asarray(m), jnp.asarray(r))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    inp, closest, idx = one_hot_mesh_encoding(torch.from_numpy(mesh), torch.from_numpy(rec))
    assert int(idx[0]) == 3 and float(inp[3, 2]) == 1.0 and float(inp[0, 2]) == 0.0
    assert inp.shape == (4, 3) and closest.tolist() == [[1.0, 1.0]]


def test_jax_meshgrid_model_fixture(record_property):
    delays = (163, 179, 191, 211, 223, 227)
    gains = np.concatenate([np.asarray(decay_times_to_gain_per_sample(
        t60, np.asarray(delays[2 * k:2 * k + 2]), 8000.0)) for k, t60 in
        enumerate((0.05, 0.08, 0.06))])
    kw = dict(sample_rate=8000.0, num_groups=3, delays=delays, gains=gains,
              use_svf_in_output=False, num_hidden_layers=1, num_neurons=16,
              num_fourier_features=4)
    jmodel = JaxDiffGFDNVarReceiverPos(encoding_type=JaxFeatureEncodingType.MESHGRID, **kw)
    rng = np.random.RandomState(0)
    mesh = rng.rand(50, 2).astype(np.float32) * 5
    pos = np.concatenate([mesh[:4], np.full((4, 1), 1.5, np.float32)], axis=1)
    x = {"z_values": np.asarray(get_frequency_samples(65)), "listener_position": pos,
         "norm_listener_position": pos / 5, "mesh_2d": mesh,
         "target_early_response": np.zeros((4, 65), np.complex64)}
    params = jmodel.init(jax.random.PRNGKey(0), x)
    h_ref = np.asarray(jmodel.apply(params, x))
    model = DiffGFDNVarReceiverPos(encoding_type=FeatureEncodingType.MESHGRID, **kw)
    assert model.output_scalars.mlp.dense[0].in_features == 3
    load_jax_params(model, params)
    with torch.no_grad():
        h = model({k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}).numpy()
    err = rel_l2(h, h_ref)
    record_property("h_rel_l2", err)
    assert h.shape == (4, 65) and err <= H_TOL


def test_svf_heads_step_and_adam_match_jax(tmp_path, record_property):
    m = option_models(tmp_path, MESH_SVF, svf=True)
    assert m.model.output_filters.mlp.dense[0].weight.shape == (16, 3)
    errs = step_errors(m)
    assert_step(errs, record_property)
    upd = adam_error(m, errs["ref_grads"])
    record_property("adam_update_max_abs_diff", upd)
    assert upd <= UPDATE_TOL
