"""The directional model's host pieces against the JAX package: the SH
machinery, the analysis matrix, the decay envelopes, the synthetic spatial
dataset and its grid split, and the 16 directional presets.

Every piece is host numpy in both packages, copied, so each must be equal
bit for bit (the split's indices equal).
"""

import dataclasses
from pathlib import Path
import pickle

import numpy as np
import pytest
import yaml

from diffgfdn_torch.config import load_and_validate_config, PRESETS, preset_config
from diffgfdn_torch.data import (
    arrays_from_spatial_dataset,
    generate_spatial_three_room_pickle,
    SpatialThreeRoomDataset,
    split_by_grid_resolution,
)
from diffgfdn_torch.losses import make_decay_envelopes
from diffgfdn_torch.models.spatial import build_analysis_matrix
from diffgfdn_torch.ops import sph
from diffgfdn_torch.ops.basic import decay_kernel
from diffgfdn_tpu.config.loader import load_and_validate_config as jax_load_config
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data import spatial_dataset as jsd
from diffgfdn_tpu.losses.spatial import make_decay_envelopes as jax_make_decay_envelopes
from diffgfdn_tpu.models.spatial import build_analysis_matrix as jax_build_analysis_matrix
from diffgfdn_tpu.ops import sph as jsph
from diffgfdn_tpu.ops.basic import decay_kernel as jax_decay_kernel
from torch_port_helpers import FS, SPATIAL_GRID_M

ROOT = Path(__file__).resolve().parents[1]
DIRECTIONAL_FILES = {p.stem: p for p in sorted((ROOT / "configs/presets/directional").glob("*.yml"))}
BEAMFORMERS = [None, "max_directivity", "max_re", "butterworth"]


def test_sh_machinery_equals_jax():
    rng = np.random.RandomState(0)
    azi, colat = rng.uniform(-np.pi, np.pi, 30), rng.uniform(0.0, np.pi, 30)
    for order in (1, 2, 3):
        np.testing.assert_array_equal(sph.sh_matrix(order, azi, colat),
                                      jsph.sh_matrix(order, azi, colat))
        for kind in BEAMFORMERS:
            c_n = sph.modal_weights(kind, order)
            np.testing.assert_array_equal(c_n, jsph.modal_weights(kind, order))
            np.testing.assert_array_equal(sph.repeat_per_order(c_n), jsph.repeat_per_order(c_n))
            for got, want in zip(sph.design_sph_filterbank(order, azi, colat, c_n),
                                 jsph.design_sph_filterbank(order, azi, colat, c_n)):
                np.testing.assert_array_equal(got, want)
    for degree in (5, 7):
        np.testing.assert_array_equal(sph.t_design_directions(degree),
                                      jsph.t_design_directions(degree))
    xyz = sph.sph_to_cart(azi, colat)
    np.testing.assert_array_equal(xyz, jsph.sph_to_cart(azi, colat))
    for got, want in zip(sph.cart_to_sph(xyz), jsph.cart_to_sph(xyz)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", BEAMFORMERS)
@pytest.mark.parametrize("order", [1, 2])
def test_analysis_matrix_equals_jax(order, kind):
    dirs = sph.t_design_directions(5)
    directions = np.stack([dirs[0], np.pi / 2 - dirs[1]])  # (azimuth, elevation)
    got = build_analysis_matrix(order, directions, kind)
    assert got.dtype == np.float32 and got.shape == (12, (order + 1) ** 2)
    np.testing.assert_array_equal(got, jax_build_analysis_matrix(order, directions, kind))


def test_decay_envelopes_equal_jax():
    times = np.array([[1.2, 2.2, 1.6]])
    got = make_decay_envelopes(times.reshape(-1), 7040, 3200.0)
    assert got.dtype.is_floating_point and tuple(got.shape) == (3, 7040)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_make_decay_envelopes(times.reshape(-1), 7040,
                                                                      3200.0)))
    t = np.arange(500) / 8000.0
    for kw in ({}, {"normalize_envelope": True}):
        np.testing.assert_array_equal(decay_kernel([0.3, 0.7], t, **kw),
                                      jax_decay_kernel([0.3, 0.7], t, **kw))


@pytest.fixture(scope="module")
def spatial_pickles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    kw = dict(fs=FS, grid_spacing_m=SPATIAL_GRID_M, rir_len_s=0.2, decay_times=(0.3, 0.5, 0.4),
              seed=5)
    return (generate_spatial_three_room_pickle(tmp / "port.pkl", **kw),
            jsd.generate_spatial_three_room_pickle(tmp / "jax.pkl", **kw))


def test_synthetic_spatial_dataset_equals_jax(spatial_pickles):
    port_path, jax_path = spatial_pickles
    with open(port_path, "rb") as f:
        port = pickle.load(f)
    with open(jax_path, "rb") as f:
        ref = pickle.load(f)
    assert set(port) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(port[key]), np.asarray(ref[key]), err_msg=key)
    assert port["srirs"].shape[1] == 9 and port["directions"].shape == (2, 12)


def test_spatial_arrays_equal_jax(spatial_pickles):
    room = SpatialThreeRoomDataset(spatial_pickles[0])
    jroom = jsd.SpatialThreeRoomDataset(spatial_pickles[0])
    assert room.num_rec == jroom.num_rec == 44
    assert room.num_freq_bins == jroom.num_freq_bins
    np.testing.assert_array_equal(room.desired_directions, jroom.desired_directions)
    np.testing.assert_array_equal(room.common_decay_times, jroom.common_decay_times)
    arrays, ref = arrays_from_spatial_dataset(room), jsd.arrays_from_spatial_dataset(jroom)
    for key in ("z_values", "source_position", "listener_position", "norm_listener_position",
                "target_common_slope_amps", "target_early_response", "target_late_response",
                "target_rir_response"):
        np.testing.assert_array_equal(getattr(arrays, key), getattr(ref, key), err_msg=key)
    assert arrays.target_rir_response.shape == (44, 9, room.num_freq_bins // 2 + 1)


def test_spatial_spectra_are_computed_on_first_read(spatial_pickles, monkeypatch):
    room = SpatialThreeRoomDataset(spatial_pickles[0])
    calls = []
    split = room.split_rirs
    monkeypatch.setattr(room, "split_rirs", lambda: calls.append(1) or split())
    arrays = arrays_from_spatial_dataset(room)
    assert calls == [] and arrays.num_items == 44
    arrays.target_early_response
    arrays.target_early_response
    assert calls == [1]


@pytest.mark.parametrize("x_d", [1.2, 2.4, 3.6])
def test_grid_split_equals_jax(spatial_pickles, x_d):
    room = SpatialThreeRoomDataset(spatial_pickles[0])
    train, valid = split_by_grid_resolution(room, x_d)
    ref_train, ref_valid = jsd.split_by_grid_resolution(jsd.SpatialThreeRoomDataset(
        spatial_pickles[0]), x_d)
    np.testing.assert_array_equal(train, ref_train)
    np.testing.assert_array_equal(valid, ref_valid)
    assert len(train) + len(valid) == room.num_rec and len(train) > 0
    with pytest.raises(ValueError, match="grid spacing"):
        split_by_grid_resolution(room, 0.1)


def test_full_size_grid_has_the_treble_grids_size():
    """The chip run's dataset: the generator's 0.3 m grid gives 847 receivers
    (the measured grid has 838), and the preset's 0.6 m split trains on 232
    (positions only: no SRIR is drawn here)."""
    from diffgfdn_torch.data.room_dataset import THREE_ROOM_DIMS, THREE_ROOM_START
    from diffgfdn_torch.data.spatial_dataset import SpatialRoomDataset

    rec = []
    for (sx, sy, _), (w, h, _) in zip(THREE_ROOM_START, THREE_ROOM_DIMS):
        xm, ym = np.meshgrid(np.arange(sx + 0.3, sx + w - 1e-6, 0.3),
                             np.arange(sy + 0.3, sy + h - 1e-6, 0.3))
        rec.append(np.stack([xm.ravel(), ym.ravel(), np.full(xm.size, 1.5)], axis=-1))
    pos = np.concatenate(rec)
    grid = SpatialRoomDataset(3, 32000.0, np.zeros(3), pos, np.zeros((len(pos), 1, 1)),
                              np.array([[1.2, 2.2, 1.6]]), THREE_ROOM_DIMS, THREE_ROOM_START)
    train, valid = split_by_grid_resolution(grid, 0.6)
    assert (len(pos), len(train), len(valid), grid.num_freq_bins) == (847, 232, 615, 131072)


@pytest.mark.parametrize("name", sorted(DIRECTIONAL_FILES))
def test_directional_presets_equal_their_yaml(name):
    with open(DIRECTIONAL_FILES[name]) as f:
        assert PRESETS[name] == yaml.safe_load(f)


@pytest.mark.parametrize("name", sorted(DIRECTIONAL_FILES))
def test_directional_preset_loads_like_the_jax_schema(name):
    port = preset_config(name)
    ref = jax_load_config(DIRECTIONAL_FILES[name], JaxDiffGFDNConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(load_and_validate_config(
        DIRECTIONAL_FILES[name]))
    assert port.num_delay_lines == ref.num_delay_lines == 27
    assert port.delay_length_samps == list(ref.delay_length_samps)
    assert port.trainer_config.train_valid_split is None
    assert port.output_filter_config.beamformer_type.value == ref.output_filter_config.beamformer_type.value
