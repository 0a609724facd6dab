"""The port's offline tools against the JAX package: ``low_rank.py``,
``data/naf.py``, ``cli/convert_dataset.py``, ``utils/flops.py``,
``utils/profiling.py``, the preset library and ``dump_config``.

Host numpy code is copied, so it must agree in float64 to 1e-10 of the
largest value; the written pickles array for array; the cost models exactly;
every preset field for field; ``trace`` writes a Chrome trace.
"""

import dataclasses
from enum import Enum
import pickle

import numpy as np
import pytest
import torch

from diffgfdn_torch import low_rank
from diffgfdn_torch.cli import convert_dataset
from diffgfdn_torch.config import (
    dump_config,
    load_and_validate_config,
    preset_library,
    write_preset_library,
)
from diffgfdn_torch.config.schema import DiffGFDNConfig, SpatialSamplingConfig
from diffgfdn_torch.data import naf
from diffgfdn_torch.utils import flops, profiling
from diffgfdn_tpu import low_rank as jax_low_rank
from diffgfdn_tpu.cli import compare_baselines as jax_compare
from diffgfdn_tpu.cli import convert_dataset as jax_convert
from diffgfdn_tpu.config import load_and_validate_config as jax_load
from diffgfdn_tpu.config.presets import preset_library as jax_preset_library
from diffgfdn_tpu.config.presets import write_preset_library as jax_write_preset_library
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.config.schema import SpatialSamplingConfig as JaxSpatialSamplingConfig
from diffgfdn_tpu.data import naf as jax_naf
from diffgfdn_tpu.data.spatial_dataset import (
    generate_spatial_three_room_pickle,
    SpatialThreeRoomDataset as JaxSpatialThreeRoomDataset,
)
from diffgfdn_tpu.ops.basic import LOG10E6
from diffgfdn_tpu.utils import flops as jax_flops

TOL = 1e-10
FS = 8000.0
BANDS = [125.0, 250.0, 500.0, 1000.0, 2000.0]


def _max_rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_low_rank_matches_jax(record_property):
    rng = np.random.RandomState(1)
    amps = np.abs(rng.rand(3, 5, 2, len(BANDS))) + 0.1
    errs = {}
    for got, want, name in zip(low_rank.get_source_receiver_gains(amps[..., 0]),
                               jax_low_rank.get_source_receiver_gains(amps[..., 0]),
                               ("g_in", "g_out", "explained")):
        errs[name] = _max_rel(got, want)
    for got, want, name in zip(low_rank.get_source_receiver_filters(amps, np.array(BANDS), FS),
                               jax_low_rank.get_source_receiver_filters(amps, np.array(BANDS),
                                                                        FS),
                               ("filters_in", "filters_out")):
        errs[name] = _max_rel(got, want)
    gi, go, ex = low_rank.rank1_decompose(amps[0, ..., 0, 0].reshape(1, -1))
    jgi, jgo, jex = jax_low_rank.rank1_decompose(amps[0, ..., 0, 0].reshape(1, -1))
    errs["rank1"] = max(_max_rel(gi, jgi), _max_rel(go, jgo), abs(ex - jex))
    record_property("max_rel", errs)
    assert max(errs.values()) <= TOL, errs
    with pytest.raises(ValueError, match="band centres"):
        low_rank.get_source_receiver_filters(amps, np.array(BANDS[:-1]), FS)


def test_barycentric_interpolation_matches_jax(record_property):
    rng = np.random.RandomState(2)
    measured = rng.rand(20, 3) * [6.0, 4.0, 0.0]
    rirs = rng.randn(20, 300)
    query = np.concatenate([rng.rand(9, 3) * [6.0, 4.0, 0.0], [[7.0, 5.0, 0.0]]])  # one outside
    got = naf.barycentric_interpolate(measured, rirs, query)
    want = jax_naf.barycentric_interpolate(measured, rirs, query)
    assert np.array_equal(got.simplex_indices, want.simplex_indices)
    errs = [_max_rel(got.rirs, want.rirs), _max_rel(got.weights, want.weights)]
    record_property("max_rel", errs)
    assert max(errs) <= TOL


@pytest.fixture(scope="module")
def spatial_pickle(tmp_path_factory):
    return generate_spatial_three_room_pickle(
        tmp_path_factory.mktemp("naf") / "sp.pkl", fs=FS, grid_spacing_m=1.2, rir_len_s=0.05,
        decay_times=(0.02, 0.03, 0.025))


def test_port_reads_jax_s_naf_export(tmp_path, spatial_pickle):
    """JAX's ``export_naf_dataset`` pickles load as the port's classes, equal
    to the port's own export of the same split."""
    from diffgfdn_torch.cli.compare_baselines import export_naf_dataset
    from diffgfdn_torch.data import SpatialThreeRoomDataset, split_by_grid_resolution

    room = SpatialThreeRoomDataset(spatial_pickle)
    train_idx, valid_idx = split_by_grid_resolution(room, 2.4)
    want = jax_compare.export_naf_dataset(JaxSpatialThreeRoomDataset(spatial_pickle),
                                          train_idx, valid_idx, tmp_path / "jax", 2.4)
    got = export_naf_dataset(room, train_idx, valid_idx, tmp_path / "port", 2.4)
    assert {k: p.name for k, p in got.items()} == {k: p.name for k, p in want.items()}
    for key in ("naf_train", "naf_infer"):
        mine, theirs = (naf.load_pickle_tolerant(p[key]) for p in (got, want))
        assert type(mine) is type(theirs) and type(mine).__module__ == naf.__name__
        for field in dataclasses.fields(mine):
            a, b = getattr(mine, field.name), getattr(theirs, field.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), field.name
            else:
                assert a == b, field.name


def test_tolerant_unpickler_refuses_other_jax_classes(tmp_path):
    from diffgfdn_tpu.training.build import ColorlessFDNResults as JaxResults

    path = tmp_path / "other.pkl"
    with open(path, "wb") as f:
        pickle.dump(JaxResults(np.ones(2), np.ones(2), np.eye(2)), f)
    with pytest.raises(pickle.UnpicklingError, match="not a NAF container"):
        naf.load_pickle_tolerant(path)


def _cs_rir(t60s, amps, n, fs, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    env = sum(a * np.exp(-t * LOG10E6 / T) for a, T in zip(amps, t60s))
    return rng.randn(n) * np.sqrt(env)


def _assert_same_pickle(got_path, want_path):
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    with open(want_path, "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want)
    errs = {}
    for k, v in want.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            errs[k] = _max_rel(got[k], v)
        elif isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k
    return errs


def test_convert_dataset_matches_jax(tmp_path, record_property):
    import h5py

    rng = np.random.RandomState(0)
    rirs = np.stack([_cs_rir([0.2, 0.4], [1.0, 0.2], 2048, FS, seed=s) for s in range(3)])
    srirs = rng.randn(2, 9, 1024) * 0.1
    for name, data, cdt in (("omni", rirs, [0.2, 0.4]), ("ambi", srirs, [[0.2, 0.4]])):
        with h5py.File(tmp_path / f"{name}.mat", "w") as f:
            f.create_dataset("fs", data=np.array([FS]))
            f.create_dataset("srirs", data=data)
            f.create_dataset("srcPos", data=np.zeros((3, 1)))
            f.create_dataset("rcvPos", data=rng.rand(3, data.shape[0]))
            f.create_dataset("common_decay_times", data=np.array(cdt))
    errs = {}
    for side, mod, kwargs in (("port", convert_dataset, {"device": "cpu"}), ("jax", jax_convert,
                                                                            {})):
        mod.convert_mat_to_pkl(tmp_path / "omni.mat", tmp_path / side / "srirs.pkl",
                               band_centre_hz=BANDS, per_band_dir=tmp_path / side / "bands")
        mod.convert_mat_to_pkl_ambi(tmp_path / "ambi.mat", tmp_path / side / "ambi.pkl",
                                    ambi_order=2, band_centre_hz=BANDS, **kwargs)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.pkl"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.pkl"))
    assert len(files) == 2 + len(BANDS)
    for rel in files:
        errs.update({f"{rel}:{k}": v for k, v in
                     _assert_same_pickle(tmp_path / "port" / rel, tmp_path / "jax" / rel).items()})
    record_property("max_rel", max(errs.values()))
    assert max(errs.values()) <= TOL, {k: v for k, v in errs.items() if v > TOL}
    directional = convert_dataset.process_srirs_to_directional(srirs, 2, device="cpu")
    assert _max_rel(directional, jax_convert.process_srirs_to_directional(srirs, 2)) <= TOL


def test_flops_match_jax():
    cases = [
        ("gfdn_flops", (12, 8)), ("gfdn_flops", (12, 8, True)), ("mlp_flops", (3, 128, 60)),
        ("dir_gfdn_flops", (2, 3, 8, 12)), ("conv_flops", (9, 4000.0, 512)),
        ("conv_flops", (9, 1000.0, 512, 32000.0)), ("mlp_mems", (3, 128, 3)),
        ("gfdn_mems", (32000.0, 12, 40.0, 3)), ("gfdn_mems", (48000.0, 27, 12.5, 3)),
    ]
    for name, args in cases:
        assert getattr(flops, name)(*args) == getattr(jax_flops, name)(*args), (name, args)


def test_profiling_prints_jax_s_strings(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.fft.rfft(torch.randn(4, 1024)).abs().sum()
    trace = tmp_path / "trace" / profiling.TRACE_FILE
    assert trace.exists() and trace.stat().st_size > 0 and "rfft" in trace.read_text()


def _normalize(x):
    """Enums as values and tuples as lists, as in pydantic's JSON dump."""
    if isinstance(x, dict):
        return {k: _normalize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normalize(v) for v in x]
    return x.value if isinstance(x, Enum) else x


def _jax_dump(cfg) -> dict:
    data = cfg.model_dump(mode="json")
    for key in ("delay_length_samps", "load_fixed_parameters", "network_type"):
        data.pop(key, None)
        for sub in data.values():
            if isinstance(sub, dict):
                sub.pop(key, None)
    return data


JAX_LIBRARY = jax_preset_library()


def test_preset_library_has_jax_s_names():
    assert sorted(preset_library()) == sorted(JAX_LIBRARY)
    assert len(JAX_LIBRARY) == 58


@pytest.mark.parametrize("name", sorted(JAX_LIBRARY))
def test_library_preset_equals_jax_s(name):
    port = preset_library()[name]()
    assert _normalize(dataclasses.asdict(port)) == _jax_dump(JAX_LIBRARY[name]())


def test_written_library_loads_back_through_both_loaders(tmp_path):
    paths = write_preset_library(tmp_path / "port")
    jax_paths = jax_write_preset_library(tmp_path / "jax")
    assert {k: p.relative_to(tmp_path / "port") for k, p in paths.items()} == {
        k: p.relative_to(tmp_path / "jax") for k, p in jax_paths.items()}
    library = preset_library()
    for name, path in paths.items():
        spatial = name.startswith("spatial")
        schema, jax_schema = ((SpatialSamplingConfig, JaxSpatialSamplingConfig) if spatial
                              else (DiffGFDNConfig, JaxDiffGFDNConfig))
        want = library[name]()
        assert load_and_validate_config(path, schema) == want, name
        assert load_and_validate_config(jax_paths[name], schema) == want, name
        assert _jax_dump(jax_load(path, jax_schema)) == _jax_dump(JAX_LIBRARY[name]()), name


def test_dump_config_keeps_explicit_nulls(tmp_path):
    cfg = preset_library()["single_rir_two_stage_colorless_proto"]()
    assert cfg.input_filter_config is not None
    cfg.input_filter_config = None  # the schema's default is an SVF head
    dump_config(cfg, tmp_path / "c.yml")
    back = load_and_validate_config(tmp_path / "c.yml", DiffGFDNConfig)
    assert back.input_filter_config is None and back == cfg
    text = (tmp_path / "c.yml").read_text()
    assert "delay_length_samps" not in text and "load_fixed_parameters" not in text
