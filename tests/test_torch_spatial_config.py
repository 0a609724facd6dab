"""Common-slopes spatial sampling in the port: the 17 presets against the JAX
schema, the three preset mappings against their YAML, the models the 17
presets build against JAX's parameter trees, the CNN preset through the
trainer, the sweep and serving, and the generator-batch ``fit`` against JAX.
"""

import dataclasses
from enum import Enum
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from diffgfdn_torch.config import (
    load_and_validate_config,
    SPATIAL_PRESETS,
    spatial_preset_config,
    SpatialSamplingConfig,
)
from diffgfdn_torch.data import SpatialThreeRoomDataset
from diffgfdn_torch.inference import get_output_from_trained_model
from diffgfdn_torch.training import (
    build_spatial_model,
    run_training_spatial_sampling,
    SpatialSamplingTrainer,
)
from diffgfdn_torch.utils.params import jax_params_from_torch
from diffgfdn_tpu.config import load_and_validate_config as jax_load_config
from diffgfdn_tpu.config.schema import SpatialSamplingConfig as JaxSpatialSamplingConfig
from diffgfdn_tpu.training.spatial_trainer import build_spatial_model as jax_build
from torch_port_helpers import cs_raw_config, cs_room_path

ROOT = Path(__file__).resolve().parents[1]
SPATIAL_DIR = ROOT / "configs/presets/spatial"
PRESET_FILES = {p.stem: p for p in sorted(SPATIAL_DIR.glob("*.yml"))}
MLP_PRESETS = sorted(n for n in PRESET_FILES if not n.endswith("_cnn"))
NUM_SLOPES, AMBI_ORDER = 3, 2


def _normalize(x):
    """Enums as values and tuples as lists, as in pydantic's JSON dump."""
    if isinstance(x, dict):
        return {k: _normalize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normalize(v) for v in x]
    return x.value if isinstance(x, Enum) else x


def test_all_seventeen_presets_are_covered():
    assert len(PRESET_FILES) == 17 and len(MLP_PRESETS) == 16


@pytest.mark.parametrize("name", sorted(PRESET_FILES))
def test_spatial_presets_load_like_the_jax_schema(name):
    """Every field, ``network_type`` included, equals JAX's ``model_dump()``."""
    port = load_and_validate_config(PRESET_FILES[name], SpatialSamplingConfig)
    ref = jax_load_config(PRESET_FILES[name], JaxSpatialSamplingConfig)
    dumped = _normalize(dataclasses.asdict(port))
    dumped["network_type"] = port.network_type.value
    assert dumped == ref.model_dump(mode="json")


@pytest.mark.parametrize("name", sorted(SPATIAL_PRESETS))
def test_spatial_preset_mappings_equal_their_yaml(name):
    with open(SPATIAL_DIR / f"{name}.yml") as f:
        assert SPATIAL_PRESETS[name] == yaml.safe_load(f)
    assert spatial_preset_config(name) == load_and_validate_config(
        SPATIAL_DIR / f"{name}.yml", SpatialSamplingConfig)


@pytest.mark.parametrize("name", MLP_PRESETS)
def test_mlp_presets_build_jax_shaped_models(name):
    """The port's model of each MLP preset carries the parameter tree JAX's
    ``build_spatial_model`` initializes (every leaf's path and shape)."""
    cfg = load_and_validate_config(PRESET_FILES[name], SpatialSamplingConfig)
    model = build_spatial_model(cfg, NUM_SLOPES, AMBI_ORDER, device="cpu")
    jcfg = jax_load_config(PRESET_FILES[name], JaxSpatialSamplingConfig)
    jmodel = jax_build(jcfg, NUM_SLOPES, AMBI_ORDER)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        {"norm_listener_position": jax.ShapeDtypeStruct((4, 3), np.float32)})
    ref = jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes)
    port = jax.tree_util.tree_map(lambda x: tuple(x.shape), jax_params_from_torch(model))
    assert port == ref
    assert type(model).__name__ == type(jmodel).__name__


def test_cnn_preset_raises_naming_a12(tmp_path):
    """The CNN preset no longer raises (ROADMAP A12's second slice is ported):
    its model carries the parameter tree JAX's ``build_spatial_model``
    initializes, and the trainer, the sweep and serving take it (their
    numbers against JAX: tests/test_torch_spatial_cnn.py)."""
    cfg = load_and_validate_config(SPATIAL_DIR / "spatial_directional_1000Hz_cnn.yml",
                                   SpatialSamplingConfig)
    assert cfg.network_type.value == "cnn"
    room = SpatialThreeRoomDataset(cs_room_path(tmp_path))
    model = build_spatial_model(cfg, NUM_SLOPES, AMBI_ORDER, device="cpu")
    jcfg = jax_load_config(SPATIAL_DIR / "spatial_directional_1000Hz_cnn.yml",
                           JaxSpatialSamplingConfig)
    shapes = jax.eval_shape(
        jax_build(jcfg, NUM_SLOPES, AMBI_ORDER).init, jax.random.PRNGKey(0),
        {"mesh_2d": jax.ShapeDtypeStruct((5, 7, 2), np.float32)})
    assert (jax.tree_util.tree_map(lambda x: tuple(x.shape), jax_params_from_torch(model))
            == jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes))
    short = dataclasses.replace(cfg, max_epochs=1, train_dir=str(tmp_path / "train"))
    results = run_training_spatial_sampling(short, room, grid_resolutions=[1.2], device="cpu")
    trainer, _ = results[1.2]
    assert isinstance(trainer, SpatialSamplingTrainer) and np.isfinite(trainer.train_loss).all()
    amps = get_output_from_trained_model(short, room, room.receiver_position[:2], 1.2,
                                         device="cpu")
    assert amps.shape == (2, 12, NUM_SLOPES)


def test_generator_batch_fit_raises_naming_a12(tmp_path):
    """The generator-batch ``fit`` is ported: on MLP receiver batches (a
    ragged last batch, so that epoch steps eagerly) and a validation batch,
    2 epochs from JAX's initialization give JAX's ``fit`` losses (1e-3
    relative at epoch 1, 1e-2 at epoch 2)."""
    from diffgfdn_tpu.training.spatial_trainer import (
        SpatialSamplingTrainer as JaxSpatialSamplingTrainer,
    )
    from torch_port_helpers import cs_configs, cs_models, cs_rooms

    jax_room, room = cs_rooms(cs_room_path(tmp_path))
    jcfg, cfg = cs_configs(cs_raw_config(tmp_path / "port", True, 2))
    jcfg.train_dir = str(tmp_path / "jax")
    jmodel, params, model = cs_models(jcfg, cfg, jax_room)
    keys = ("norm_listener_position", "listener_position")
    amps = np.asarray(room.amplitudes, np.float32)

    def batch(idx):
        out = {k: getattr(room, k.replace("listener", "receiver"))[idx].astype(np.float32)
               for k in keys}
        return {**out, "target_common_slope_amps": amps[idx]}

    order = np.random.RandomState(3).permutation(room.num_rec)
    train = [batch(order[a:b]) for a, b in ((0, 16), (16, 32), (32, 40))]
    valid = [batch(order[40:56])]
    jtrainer = JaxSpatialSamplingTrainer(jmodel, jcfg, jax_room)
    jtrainer.fit(params, lambda epoch: iter(train), lambda: iter(valid))
    trainer = SpatialSamplingTrainer(model, cfg, room, device="cpu")
    trainer.fit(lambda epoch: iter(train), lambda: iter(valid))
    for port, ref in ((trainer.train_loss, jtrainer.train_loss),
                      (trainer.valid_loss, jtrainer.valid_loss)):
        errs = [abs(p - r) / abs(r) for p, r in zip(port, ref)]
        assert len(errs) == 2 and errs[0] <= 1e-3 and errs[1] <= 1e-2, errs
    assert len(list(trainer.graphs)) == 1  # the valid batch; the ragged epochs step eagerly


def test_spatial_config_rejects_unknown_keys_and_bad_values():
    with pytest.raises(ValueError, match="num_grid_spacings"):
        SpatialSamplingConfig.from_dict({"num_grid_spacings": 3})
    with pytest.raises(ValueError, match="num_neurons"):
        SpatialSamplingConfig.from_dict({"dnn_config": {"mlp_config": {"num_neurons": 3}}})
    with pytest.raises(ValueError):
        SpatialSamplingConfig.from_dict({"dnn_config": {"beamformer_type": "nope"}})
    with pytest.raises(ValueError, match="kernel_size"):
        SpatialSamplingConfig.from_dict({"dnn_config": {"cnn_config": {"kernel_size": [3]}}})
