"""The baseline-comparison CLI against the JAX package, on JAX's workflow
fixture (``tests/test_cli_and_analysis.py:400``: a 0.6 m spatial grid at
8 kHz, 0.12 s SRIRs, split at 1.2 m, a 1 x 16 MLP).

Both ``main``s train the common-slopes MLP from the same initial parameters
(JAX's ``init`` at the config's seed, carried into the port by
``utils/params.py``) and serve it on the same noise (JAX's ``fold_in``
stream, ``cs_synthesis.draw_noise`` patched). Bounds: the barycentric
baseline's per-receiver, per-direction EDC-error map within 1e-10 dB of
JAX's; the MLP's within 0.01 dB; the same output files, summary keys and
split; the NAF exports read back. One epoch in tier-1; JAX's two under
``slow``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from diffgfdn_torch.cli import compare_baselines as port_cli
from diffgfdn_torch.data.naf import load_pickle_tolerant
from diffgfdn_torch.inference import cs_synthesis
from diffgfdn_torch.training import spatial_trainer
from diffgfdn_torch.utils.params import load_jax_params
from diffgfdn_tpu.cli import compare_baselines as jax_cli
from diffgfdn_tpu.config.schema import DNNConfig, MLPConfig, SpatialSamplingConfig
from diffgfdn_tpu.data.spatial_dataset import (
    generate_spatial_three_room_pickle,
    SpatialThreeRoomDataset,
)
from diffgfdn_tpu.training.spatial_trainer import build_spatial_model as jax_build

BARY_TOL_DB = 1e-10
MODEL_TOL_DB = 0.01
SEED = 0


def _jax_noise(key, shape):
    return np.array(jax.random.normal(key, shape))  # a writable copy for torch.from_numpy


def _recorder(monkeypatch, module, store: list):
    original = module.edc_error_db

    def record(ref, pred, mix):
        out = original(ref, pred, mix)
        store.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "edc_error_db", record)


def _run(tmp_path, monkeypatch, epochs: int, record_property):
    pkl = generate_spatial_three_room_pickle(
        tmp_path / "sp.pkl", fs=8000.0, grid_spacing_m=0.6, rir_len_s=0.12,
        decay_times=(0.04, 0.07, 0.05))
    args = ["--dataset", str(pkl), "--grid-resolution", "1.2", "--max-epochs", str(epochs),
            "--mlp-layers", "1", "--mlp-neurons", "16"]
    maps = {"jax": [], "port": []}
    _recorder(monkeypatch, jax_cli, maps["jax"])
    _recorder(monkeypatch, port_cli, maps["port"])
    jax_cli.main(args + ["--out", str(tmp_path / "jax")])

    # the port from JAX's initial parameters, on JAX's noise
    room = SpatialThreeRoomDataset(pkl)
    jcfg = SpatialSamplingConfig(
        room_dataset_path=str(pkl), batch_size=16, seed=SEED, max_epochs=epochs, lr=5e-3,
        use_directional_rirs=True,
        dnn_config=DNNConfig(mlp_config=MLPConfig(num_hidden_layers=1,
                                                  num_neurons_per_layer=16),
                             num_fourier_features=10))
    example = {"norm_listener_position": room.norm_receiver_position[:16].astype(np.float32)}
    params = jax_build(jcfg, room.num_rooms, room.ambi_order).init(
        jax.random.PRNGKey(SEED), example)
    build = spatial_trainer.build_spatial_model

    def build_from_jax_init(*a, **kw):
        return load_jax_params(build(*a, **kw), params)

    monkeypatch.setattr(spatial_trainer, "build_spatial_model", build_from_jax_init)
    key = jax.random.PRNGKey(SEED)

    def jax_draw(shape, generator, device):
        return torch.from_numpy(np.stack([_jax_noise(jax.random.fold_in(key, j), shape[1:])
                                          for j in range(shape[0])]))

    monkeypatch.setattr(cs_synthesis, "draw_noise", jax_draw)
    port_cli.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])

    summaries = {side: json.loads((tmp_path / side / "comparison_summary.json").read_text())
                 for side in ("jax", "port")}
    got, want = summaries["port"], summaries["jax"]
    assert sorted(got) == sorted(want)
    for key_ in ("grid_resolution_m", "num_train", "num_heldout"):
        assert got[key_] == want[key_]
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        p.name for p in (tmp_path / "jax").iterdir()}
    # [model, barycentric], each (P, J)
    assert [m.shape for m in maps["port"]] == [m.shape for m in maps["jax"]]
    model_err = float(np.abs(maps["port"][0] - maps["jax"][0]).max())
    bary_err = float(np.abs(maps["port"][1] - maps["jax"][1]).max())
    record_property("model_map_max_abs_db", model_err)
    record_property("barycentric_map_max_abs_db", bary_err)
    assert bary_err <= BARY_TOL_DB
    assert model_err <= MODEL_TOL_DB
    for name in ("common_slopes_model", "barycentric"):
        assert np.isfinite(got[f"{name}_mean_edc_error_db"]) and len(
            got[f"{name}_per_direction_db"]) == 12
    train = load_pickle_tolerant(got["naf_exports"]["naf_train"])
    infer = load_pickle_tolerant(got["naf_exports"]["naf_infer"])
    assert train.rirs.shape[0] == got["num_train"]
    assert infer.receiver_position.shape[0] == got["num_heldout"]


def test_compare_baselines_matches_jax(tmp_path, monkeypatch, record_property):
    _run(tmp_path, monkeypatch, 1, record_property)


@pytest.mark.slow
def test_compare_baselines_matches_jax_two_epochs(tmp_path, monkeypatch, record_property):
    """JAX's own fixture's two epochs."""
    _run(tmp_path, monkeypatch, 2, record_property)
