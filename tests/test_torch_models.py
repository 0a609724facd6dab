"""Model-level parity: DiffGFDNVarReceiverPos in the port against the JAX package.

The JAX model is initialized (flax ``init``), its parameters are carried into
the port by diffgfdn_torch.utils.params, and both evaluate H(z) on the same
batch (nfft 2^12, batch 4, narrow MLPs). Both head kinds, with zero and with
learned (Givens-angle) coupling. Bound: relative L2 error of H <= 2e-3 — the
float32 phase of z^m (delays up to ~360 samples here) is rounded differently
by jnp and torch powers, which sets the floor.
"""

import jax
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.utils.params import (
    jax_params_from_torch,
    load_jax_params,
    torch_state_from_jax,
)
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset, gather_batch
from torch_port_helpers import jax_model_and_params, raw_config, rel_l2, rooms

NFFT = 4096
BATCH = 4
H_TOL = 2e-3


def _batch(room, idx):
    batch = gather_batch(arrays_from_room_dataset(room), idx)
    keys = ("z_values", "listener_position", "norm_listener_position",
            "target_early_response", "source_position")
    return {k: batch[k] for k in keys}


@pytest.mark.parametrize("svf", [True, False], ids=["svf_heads", "scalar_heads"])
@pytest.mark.parametrize("zero_coupling", [True, False], ids=["zero_coupling", "learned_alpha"])
def test_transfer_function_matches_jax(tmp_path, svf, zero_coupling):
    raw = raw_config(tmp_path, svf, zero_coupling, nfft=NFFT, batch=BATCH)
    jax_room, port_room = rooms(tmp_path, svf, NFFT)
    jax_model, params = jax_model_and_params(
        JaxDiffGFDNConfig.model_validate(raw), jax_room, BATCH
    )
    batch = _batch(jax_room, np.array([0, 2, 4, 8]))
    h_ref = np.asarray(jax.jit(jax_model.apply)(params, batch))

    model = build_gfdn_model(
        DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
        port_room.band_centre_hz, device="cpu",
    )
    load_jax_params(model, params)
    with torch.no_grad():
        h = model({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}).numpy()
    assert h.shape == h_ref.shape == (BATCH, NFFT // 2 + 1)
    # compare the feedback-loop part: the early response is added identically
    direct = batch["target_early_response"]
    assert rel_l2(h - direct, h_ref - direct) <= H_TOL


def test_parameter_trees_round_trip(tmp_path):
    raw = raw_config(tmp_path, svf=True, zero_coupling=False)
    jax_room, port_room = rooms(tmp_path, True, NFFT)
    _, params = jax_model_and_params(JaxDiffGFDNConfig.model_validate(raw), jax_room, BATCH)
    model = build_gfdn_model(
        DiffGFDNConfig.from_dict(raw), port_room.common_decay_times,
        port_room.band_centre_hz, device="cpu",
    )
    load_jax_params(model, params)
    back = jax_params_from_torch(model)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat[path], np.asarray(leaf))
    state = torch_state_from_jax(params)
    assert state["output_filters.mlp.dense.0.weight"].shape == (16, 24)  # (out, in)


def test_seeded_init_is_deterministic():
    cfg = DiffGFDNConfig.from_dict(dict(
        seed=3, sample_rate=8000.0, num_delay_lines=6, delay_range_ms=[20.0, 45.0],
        decay_filter_config=dict(use_absorption_filters=False),
        output_filter_config=dict(use_svfs=False, num_hidden_layers=1,
                                  num_neurons_per_layer=8, num_fourier_features=2),
    ))
    a = build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), device="cpu").state_dict()
    b = build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), device="cpu").state_dict()
    cfg.seed = 4
    c = build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["feedback_loop.M"], c["feedback_loop.M"])


@pytest.mark.parametrize(
    "override,item",
    [
        ({"feedback_loop_config": {"coupling_matrix_type": "filter_matrix"}}, "A4"),
        ({"feedback_loop_config": {"coupling_matrix_type": "random_matrix"}}, "A4"),
        ({"colorless_fdn_config": {"use_colorless_prototype": True}}, "A10"),
        ({"output_filter_config": {"encoding_type": "meshgrid"}}, "A4"),
        ({"decay_filter_config": {"learn_common_decay_times": True}}, "A7"),
    ],
)
def test_unported_options_raise_naming_the_roadmap_item(override, item):
    raw = dict(seed=3, sample_rate=8000.0, num_delay_lines=6, delay_range_ms=[20.0, 45.0],
               decay_filter_config=dict(use_absorption_filters=False))
    for key, val in override.items():
        raw[key] = {**raw.get(key, {}), **val}
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        build_gfdn_model(DiffGFDNConfig.from_dict(raw), np.array([0.5, 0.6, 0.7]), device="cpu")


def test_other_variants_raise():
    cfg = DiffGFDNConfig.from_dict(dict(seed=3, sample_rate=8000.0, num_delay_lines=6,
                                        delay_range_ms=[20.0, 45.0]))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), variant="directional", device="cpu")


@pytest.mark.parametrize("zero_coupling", [True, False], ids=["zero_coupling", "learned_alpha"])
def test_general_transfer_function_matches_jax(tmp_path, zero_coupling):
    """DiffGFDN.transfer_function with per-line (B, N, F) heads, through the
    full (F, N, N) loop response P(z)."""
    raw = raw_config(tmp_path, svf=False, zero_coupling=zero_coupling, nfft=512)
    jax_room, port_room = rooms(tmp_path, False, 512)
    jax_model, params = jax_model_and_params(
        JaxDiffGFDNConfig.model_validate(raw), jax_room, BATCH
    )
    rng = np.random.RandomState(5)
    f = 257
    z = arrays_from_room_dataset(jax_room).z_values
    c, b = ((rng.randn(2, 12, f) + 1j * rng.randn(2, 12, f)).astype(np.complex64)
            for _ in range(2))
    ref = np.asarray(jax_model.apply(params, z, c, b, method=type(jax_model).transfer_function))
    model = build_gfdn_model(
        DiffGFDNConfig.from_dict(raw), port_room.common_decay_times, device="cpu"
    )
    load_jax_params(model, params)
    with torch.no_grad():
        h = model.transfer_function(*(torch.from_numpy(x) for x in (z, c, b))).numpy()
    assert rel_l2(h, ref) <= H_TOL
