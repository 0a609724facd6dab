"""SH rotations, SOFA I/O and the SRIR-to-BRIR conversion against the JAX
package, on JAX's own inputs (tests/test_inference.py): rotations and the
HRIR reader within 1e-12, the writer's files equal but for their
timestamps, the BRIRs within 1e-5 relative L2 of JAX's float64 ones.
"""

import h5py
import numpy as np
import pytest

from diffgfdn_torch.inference import sofa as port
from diffgfdn_torch.ops import sph as port_sph
from diffgfdn_tpu.inference import sofa as ref
from diffgfdn_tpu.ops import sph as ref_sph
from diffgfdn_tpu.ops.sph import t_design_directions
from torch_port_helpers import rel_l2

FS = 8000.0
HOST_TOL = 1e-12
BRIR_TOL = 1e-5
# written anew by every write: the dates and the measurement times
TIMESTAMPS = {"DateCreated", "DateModified", "MeasurementDate"}


@pytest.mark.parametrize("order", [1, 2, 3])
def test_sh_rotations_match_jax(order, record_property):
    rng = np.random.RandomState(order)
    worst = 0.0
    for yaw, pitch, roll in rng.uniform(-np.pi, np.pi, (6, 3)):
        got = port_sph.sh_rotation_yaw_pitch_roll(order, yaw, pitch, roll)
        want = ref_sph.sh_rotation_yaw_pitch_roll(order, yaw, pitch, roll)
        worst = max(worst, float(np.abs(got - want).max()))
        zyz = port_sph.sh_rotation_matrix(order, port_sph.rotation_matrix_zyz(yaw, pitch, roll))
        zyz_ref = ref_sph.sh_rotation_matrix(order, ref_sph.rotation_matrix_zyz(yaw, pitch, roll))
        worst = max(worst, float(np.abs(zyz - zyz_ref).max()))
        # a rotation: orthogonal, block-diagonal per order
        assert np.allclose(got @ got.T, np.eye((order + 1) ** 2), atol=1e-12)
    record_property("max_abs_err", worst)
    assert worst <= HOST_TOL


def _hrir_arrays(cartesian=False):
    """JAX's mock HRIR set: impulse HRIRs plus noise on the icosahedron."""
    dirs = t_design_directions(5)
    azi = np.rad2deg(dirs[0])
    ele = np.rad2deg(np.pi / 2 - dirs[1])
    m = len(azi)
    rng = np.random.RandomState(3)
    irs = np.zeros((m, 2, 32))
    irs[:, :, 0] = 1.0
    irs += 0.01 * rng.randn(m, 2, 32)
    pos = np.stack([azi, ele, np.ones(m)], axis=-1)
    if cartesian:
        a, e = np.deg2rad(azi), np.deg2rad(ele)
        pos = 1.5 * np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], axis=-1)
    return irs, pos


def _write_hrir_file(path, cartesian=False):
    irs, pos = _hrir_arrays(cartesian)
    with h5py.File(path, "w") as f:
        f.create_dataset("Data.IR", data=irs)
        f.create_dataset("Data.SamplingRate", data=np.array([FS]))
        sp = f.create_dataset("SourcePosition", data=pos)
        sp.attrs["Units"] = "metre" if cartesian else "degree, degree, metre"
    return path


@pytest.mark.parametrize("cartesian", [False, True], ids=["degrees", "cartesian"])
def test_hrir_reader_matches_jax(tmp_path, cartesian, record_property):
    path = _write_hrir_file(tmp_path / "hrir.sofa", cartesian)
    got, want = port.HRIRSOFAReader(path), ref.HRIRSOFAReader(path)
    irs, pos = _hrir_arrays(cartesian)
    built = port.HRIRSOFAReader.from_arrays(
        irs, FS, pos, "metre" if cartesian else "degree, degree, metre")
    for reader in (got, built):
        assert (reader.num_meas, reader.num_receivers, reader.ir_length) == (12, 2, 32)
        assert reader.source_units == want.source_units and reader.fs == want.fs
    rng = np.random.RandomState(5)
    views = np.stack([rng.uniform(-180, 180, 7), rng.uniform(-90, 90, 7)], axis=-1)
    errs = {
        "listener_view": np.abs(got.listener_view - want.listener_view).max(),
        "ir_from_view": np.abs(got.get_ir_from_view(views) - want.get_ir_from_view(views)).max(),
        "sh_order2": np.abs(got.get_spherical_harmonic_representation(2)
                            - want.get_spherical_harmonic_representation(2)).max(),
    }
    # the array-built reader gives what the file-built one gives
    assert np.array_equal(built.get_spherical_harmonic_representation(2),
                          got.get_spherical_harmonic_representation(2))
    assert np.array_equal(built.listener_view, got.listener_view)
    got.resample_hrirs(2 * FS)
    want.resample_hrirs(2 * FS)
    built.resample_hrirs(2 * FS)
    errs["resampled"] = np.abs(got.ir_data - want.ir_data).max()
    assert got.ir_length == want.ir_length == 64 and got.fs == want.fs
    assert np.array_equal(built.ir_data, got.ir_data)
    for name, err in errs.items():
        record_property(name, float(err))
    assert max(errs.values()) <= HOST_TOL, errs


def _write_both(tmp_path, sources):
    rng = np.random.RandomState(0)
    irs = rng.randn(3, 4, 64)
    positions = rng.rand(3, 3)
    paths = {}
    for name, module in (("port", port), ("jax", ref)):
        writer = module.SRIRSOFAWriter(num_receivers=3, ambi_order=1, ir_length=64,
                                       samplerate=FS)
        writer.set_ir_data(irs)
        writer.set_receiver_positions(positions)
        writer.set_source_positions(sources)
        paths[name] = tmp_path / f"{name}.sofa"
        writer.write_to_file(paths[name])
    return paths


def _contents(path):
    """{name: (value, attrs, dimension scales)} of every dataset, and the root attrs."""
    out = {}
    with h5py.File(path, "r") as f:
        root = {k: v for k, v in f.attrs.items() if k not in TIMESTAMPS}
        for name, ds in f.items():
            attrs = {k: v for k, v in ds.attrs.items()
                     if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}
            scales = [[s.name for s in ds.dims[a].values()] for a in range(len(ds.dims))]
            value = None if name in TIMESTAMPS else ds[()]
            out[name] = (value, attrs, scales, ds.dtype, h5py.h5ds.is_scale(ds.id))
        return root, out


@pytest.mark.parametrize("per_measurement", [False, True], ids=["one_source", "per_measurement"])
def test_sofa_writer_matches_jax(tmp_path, per_measurement):
    sources = (np.random.RandomState(1).rand(3, 3) if per_measurement
               else np.array([[1.0, 2.0, 1.5]]))
    paths = _write_both(tmp_path, sources)
    root, data = _contents(paths["port"])
    root_ref, data_ref = _contents(paths["jax"])
    assert root.keys() == root_ref.keys()
    for key in root:
        assert np.array_equal(root[key], root_ref[key]), key
    assert list(data) == list(data_ref)
    for name, (value, attrs, scales, dtype, is_scale) in data.items():
        value_ref, attrs_ref, scales_ref, dtype_ref, is_scale_ref = data_ref[name]
        assert dtype == dtype_ref and is_scale == is_scale_ref and scales == scales_ref, name
        assert attrs.keys() == attrs_ref.keys(), name
        for key in attrs:
            assert np.array_equal(attrs[key], attrs_ref[key]), (name, key)
        if value is not None:
            assert np.array_equal(value, value_ref), name
    with h5py.File(paths["port"], "r") as f:
        assert np.allclose(f["SourcePosition"], np.broadcast_to(sources, (3, 3)))


def test_sofa_writer_netcdf4_conformance(tmp_path):
    """The port's files carry netCDF4 structure, as JAX's conformance test
    holds its own writer's (tests/test_inference.py)."""
    path = _write_both(tmp_path, np.array([[1.0, 2.0, 1.5]]))["port"]
    expected_dims = {"M": 3, "R": 4, "N": 64, "E": 1, "C": 3, "I": 1}
    var_dims = {
        "Data.IR": ("M", "R", "N"), "Data.SamplingRate": ("I",), "Data.Delay": ("I", "R"),
        "ListenerPosition": ("M", "C"), "ListenerView": ("I", "C"), "ListenerUp": ("I", "C"),
        "ReceiverPosition": ("R", "C", "I"), "ReceiverView": ("R", "C", "I"),
        "ReceiverUp": ("R", "C", "I"), "SourcePosition": ("M", "C"),
        "SourceView": ("I", "C"), "SourceUp": ("I", "C"),
        "EmitterPosition": ("E", "C", "I"), "MeasurementDate": ("M",),
    }
    with h5py.File(path, "r") as f:
        assert f.attrs["_NCProperties"].startswith(b"version=2")
        for attr in ("Conventions", "Version", "SOFAConventions", "SOFAConventionsVersion",
                     "DataType", "RoomType", "License", "DateCreated", "Title", "APIName"):
            assert attr in f.attrs, attr
        assert f.attrs["SOFAConventions"] == "SingleRoomSRIR"
        assert f.attrs["DataType"] == "FIR"
        for name, size in expected_dims.items():
            d = f[name]
            assert h5py.h5ds.is_scale(d.id), name
            assert d.shape == (size,)
            assert d.attrs["CLASS"] == b"DIMENSION_SCALE"
            assert d.attrs["NAME"].startswith(
                b"This is a netCDF dimension but not a netCDF variable.")
            assert "_Netcdf4Dimid" in d.attrs and "REFERENCE_LIST" in d.attrs, name
        for name, dims in var_dims.items():
            ds = f[name]
            assert "DIMENSION_LIST" in ds.attrs, name
            assert len(ds.dims) == len(dims)
            for axis, dim_name in enumerate(dims):
                scales = list(ds.dims[axis].values())
                assert len(scales) == 1 and scales[0] == f[dim_name], (name, axis)
        assert f["ListenerPosition"].attrs["Type"] == "cartesian"
        assert f["Data.SamplingRate"].attrs["Units"] == "hertz"

    writer = port.SRIRSOFAWriter(num_receivers=3, ambi_order=1, ir_length=64, samplerate=FS)
    writer.set_source_positions(np.random.RandomState(2).rand(2, 3))
    with pytest.raises(ValueError, match="SourcePosition"):
        writer.write_to_file(tmp_path / "bad.sofa")


def test_convert_srir_to_brir_matches_jax(tmp_path, record_property, monkeypatch):
    path = _write_hrir_file(tmp_path / "hrir.sofa")
    rng = np.random.RandomState(0)
    srirs = rng.randn(5, 9, 700)
    oris = np.array([[0.0, 0.0], [np.pi / 2, 0.0], [1.0, -0.3], [-2.5, 0.4]])
    want = ref.convert_srir_to_brir(srirs, ref.HRIRSOFAReader(path), oris)
    reader = port.HRIRSOFAReader(path)
    got = port.convert_srir_to_brir(srirs, reader, oris, device="cpu")
    assert got.shape == want.shape == (5, 4, 1024, 2) and got.dtype == np.float64
    errs = [rel_l2(got[p, o], want[p, o]) for p in range(5) for o in range(4)]
    record_property("max_rel_l2_per_brir", max(errs))
    assert max(errs) <= BRIR_TOL
    # chunks of one receiver give the same BRIRs
    monkeypatch.setattr(port, "BRIR_CHUNK_BYTES", 1)
    assert np.array_equal(port.convert_srir_to_brir(srirs, reader, oris, device="cpu"), got)

