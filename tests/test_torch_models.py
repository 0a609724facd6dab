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
from diffgfdn_tpu.training.build import build_gfdn_model as jax_build_gfdn_model
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
    "override",
    [
        {"feedback_loop_config": {"coupling_matrix_type": "filter_matrix"}},
        {"output_filter_config": {"encoding_type": "meshgrid", "use_svfs": False}},
        {"output_filter_config": {"encoding_type": "meshgrid"}},
        {"decay_filter_config": {"learn_common_decay_times": True}},
    ],
    ids=["filter_coupling", "meshgrid_scalar_heads", "meshgrid_svf_heads",
         "learned_decay_times"],
)
def test_options_build_the_jax_parameter_tree(override):
    """FILTER coupling, meshgrid heads and learnable decay times (ROADMAP A4,
    A7) build, with JAX's ``init`` tree: every leaf's name and shape."""
    raw = dict(seed=3, sample_rate=8000.0, num_delay_lines=6, delay_range_ms=[20.0, 45.0],
               decay_filter_config=dict(use_absorption_filters=False))
    for key, val in override.items():
        raw[key] = {**raw.get(key, {}), **val}
    cdt = np.array([0.5, 0.6, 0.7])
    model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), cdt, device="cpu")
    jmodel = jax_build_gfdn_model(JaxDiffGFDNConfig.model_validate(raw), common_decay_times=cdt,
                                  use_pallas_inverse=False)
    rng = np.random.RandomState(0)
    pos = rng.uniform(0.0, 5.0, (2, 3)).astype(np.float32)
    example = {"z_values": np.exp(1j * np.linspace(0.0, np.pi, 9)).astype(np.complex64),
               "listener_position": pos, "norm_listener_position": pos / 5.0,
               "source_position": pos, "mesh_2d": rng.uniform(0.0, 5.0, (7, 2)).astype(
                   np.float32), "target_early_response": np.zeros((2, 9), np.complex64)}
    example = jax.tree_util.tree_map(jax.numpy.asarray, example)  # a traced mesh is indexed
    tree = jax.eval_shape(lambda k: jmodel.init(k, example), jax.random.PRNGKey(0))
    mapped = torch_state_from_jax(jax.tree_util.tree_map(lambda v: np.zeros(v.shape), tree))
    assert len(mapped) == len(jax.tree_util.tree_leaves(tree))
    assert ({k: tuple(v.shape) for k, v in mapped.items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})


def test_other_variants_raise():
    """The source-conditioned variant builds, with input heads from
    ``input_filter_config`` (its parity with JAX is in
    test_torch_var_source.py); an unknown variant raises. The
    single-position one builds (its parity with JAX is in
    test_torch_single_pos.py), and so does the directional one (in
    test_torch_directional_model.py). RANDOM coupling with the colorless
    loss is refused as JAX refuses it."""
    cfg = DiffGFDNConfig.from_dict(dict(seed=3, sample_rate=8000.0, num_delay_lines=6,
                                        delay_range_ms=[20.0, 45.0]))
    source = build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), variant="var_source_receiver",
                              device="cpu")
    assert source.use_svf_in_output and source.use_svf_in_input
    assert source.input_filters.position_key == "source_position"
    assert source.input_filters.mlp.dense[0].out_features == 128
    with pytest.raises(ValueError, match="unknown variant"):
        build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), variant="var_source", device="cpu")
    single = build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), variant="single_pos",
                              device="cpu")
    assert {n for n, _ in single.named_parameters()} == {
        "input_gains", "output_gains", "feedback_loop.M", "output_svf_params", "input_svf_params"}
    random_loss = DiffGFDNConfig.from_dict(dict(
        seed=3, sample_rate=8000.0, num_delay_lines=6, delay_range_ms=[20.0, 45.0],
        feedback_loop_config=dict(coupling_matrix_type="random_matrix"),
        trainer_config=dict(use_colorless_loss=True)))
    with pytest.raises(ValueError, match="RANDOM has no per-group sub-FDNs"):
        build_gfdn_model(random_loss, np.array([0.5, 0.6, 0.7]), device="cpu")
    directional = DiffGFDNConfig.from_dict(dict(
        seed=3, sample_rate=8000.0, ambi_order=1, delay_range_ms=[20.0, 45.0],
        decay_filter_config=dict(use_absorption_filters=False),
        output_filter_config=dict(use_svfs=False, num_hidden_layers=1,
                                  num_neurons_per_layer=8, num_fourier_features=2)))
    directions = np.stack([np.linspace(-3.0, 3.0, 12), np.linspace(-1.0, 1.0, 12)])
    model = build_gfdn_model(directional, np.array([0.5, 0.6, 0.7]), variant="directional",
                             device="cpu", desired_directions=directions)
    assert model.num_delay_lines == 12 and tuple(model.analysis_matrix.shape) == (12, 4)
    with pytest.raises(ValueError, match="desired_directions"):
        build_gfdn_model(directional, np.array([0.5, 0.6, 0.7]), variant="directional",
                         device="cpu")


def test_random_coupling_builds_a_dense_loop():
    """RANDOM coupling of a GFDN builds (ROADMAP A4's part that the synth
    preset ``synth_subband_single_room`` needs): one (N, N) skew pre-image,
    a dense loop, H at every bin (its parity with JAX is in
    test_torch_random_gfdn.py)."""
    cfg = DiffGFDNConfig.from_dict(dict(
        seed=3, sample_rate=8000.0, num_delay_lines=6, delay_range_ms=[20.0, 45.0],
        feedback_loop_config=dict(coupling_matrix_type="random_matrix"),
        decay_filter_config=dict(use_absorption_filters=False),
        output_filter_config=dict(use_svfs=False, num_hidden_layers=1,
                                  num_neurons_per_layer=8, num_fourier_features=2)))
    model = build_gfdn_model(cfg, np.array([0.5, 0.6, 0.7]), device="cpu")
    assert {n for n, _ in model.named_parameters() if n.startswith("feedback_loop")} == {
        "feedback_loop.random_feedback_matrix"}
    assert not model.feedback_loop.is_block_diagonal
    z = torch.exp(1j * torch.linspace(0.0, np.pi, 65)).to(torch.complex64)
    pos = torch.rand((2, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        h = model({"z_values": z, "listener_position": pos, "norm_listener_position": pos})
    assert h.shape == (2, 65) and bool(torch.isfinite(h).all())


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
