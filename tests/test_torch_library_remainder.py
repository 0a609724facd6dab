"""The last public functions of the JAX package that the port lacked, against
the JAX package on seeded inputs, and ROADMAP C22.

* ``ops/biquad.py``: the RBJ designers (host numpy) exactly;
  ``biquad_freqz`` / ``sosfreqz`` (torch) within 1e-5 of the largest value
  at nfft 4096, 3e-5 at nfft 512 (both packages' float32 rounding there,
  held to float64 too: see ``FREQZ_TOL``);
* ``ops/absorption.py absorption_to_gain_per_sample`` and the activations of
  ``models/dnn.py`` within 1e-6 relative (tan_sigmoid where tan is well
  conditioned; near its pole no further from float64 than JAX's);
* ``data/room_dataset.py``: ``freq_bins_hz``, the dataset mutators and
  ``save_individual_irs`` (the same file names, equal samples) exactly;
* ``config/presets.py``: the six preset factories equal JAX's configs field
  by field, with their default and with other paths;
* C22: time-domain synthesis of ``DiffGFDNSinglePos`` fails in JAX (scalar
  heads: ``TypeError``; SVF heads: ``AttributeError``), and the port refuses
  it with ``ValueError`` naming C22.
"""

import dataclasses
from enum import Enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config import presets
from diffgfdn_torch.data import RIRData, RoomDataset
from diffgfdn_torch.data.audio import read_wav
from diffgfdn_torch.inference import make_time_domain_synthesis_fn
from diffgfdn_torch.models import dnn
from diffgfdn_torch.ops import absorption, biquad
from diffgfdn_tpu.config import presets as jax_presets
from diffgfdn_tpu.data.room_dataset import RIRData as JaxRIRData
from diffgfdn_tpu.data.room_dataset import RoomDataset as JaxRoomDataset
from diffgfdn_tpu.inference.gfdn_inference import (
    make_time_domain_synthesis_fn as jax_make_time_domain_synthesis_fn,
)
from diffgfdn_tpu.models import dnn as jax_dnn
from diffgfdn_tpu.ops import absorption as jax_absorption
from diffgfdn_tpu.ops import biquad as jax_biquad
from torch_port_helpers import max_rel, one_torch_thread  # noqa: F401 (a module fixture)
from torch_port_helpers import single_pos_models, single_pos_raw

FS = 48000.0


@pytest.mark.parametrize("name", ["lowpass_filter_np", "highpass_filter_np"])
def test_rbj_designers_equal_jax(name):
    for fc, gain in ((100.0, 0.0), (1234.5, -6.0), (15000.0, 3.5)):
        for got, want in zip(getattr(biquad, name)(fc, FS, gain),
                             getattr(jax_biquad, name)(fc, FS, gain)):
            np.testing.assert_array_equal(got, want)


def test_bandpass_designer_equals_jax():
    for fc1, fc2, gain in ((100.0, 400.0, 0.0), (707.0, 1414.0, -3.0), (3000.0, 9000.0, 6.0)):
        for got, want in zip(biquad.bandpass_filter_np(fc1, fc2, FS, gain),
                             jax_biquad.bandpass_filter_np(fc1, fc2, FS, gain)):
            np.testing.assert_array_equal(got, want)


def _sections(rng, count: int) -> np.ndarray:
    """Stable second-order sections: the RBJ designs at random corners."""
    rows = []
    for fc in rng.uniform(200.0, 8000.0, count):
        b, a = biquad.lowpass_filter_np(fc, FS, rng.uniform(-6.0, 6.0))
        rows.append(np.concatenate([b, a]))
    return np.stack(rows).astype(np.float32)


# four low-pass sections, corners 200-8000 Hz: float32 rFFTs of the
# coefficients put both packages 1.1e-5 (JAX) and 1.8e-5 (the port) of the
# largest value from float64 at nfft 512 (the low corners' resonances), and
# under 4e-6 at nfft 4096
FREQZ_TOL = {512: 3e-5, 4096: 1e-5}  # port vs JAX, of the largest value
FREQZ_F64_TOL = 2e-5  # port vs float64, of the largest value


@pytest.mark.parametrize("nfft", [512, 4096])
def test_freqz_match_jax(nfft, record_property):
    sos = _sections(np.random.RandomState(nfft), 4)
    s64 = sos.astype(np.float64)
    exact = (np.prod(np.fft.rfft(s64[:, :3], nfft, axis=-1), axis=0)
             / np.prod(np.fft.rfft(s64[:, 3:], nfft, axis=-1), axis=0))
    got = biquad.sosfreqz(torch.from_numpy(sos), nfft).numpy()
    want = np.asarray(jax_biquad.sosfreqz(jnp.asarray(sos), nfft))
    record_property("sosfreqz_rel_vs_jax", max_rel(got, want))
    assert max_rel(got, want) <= FREQZ_TOL[nfft] and max_rel(got, exact) <= FREQZ_F64_TOL
    b, a = np.ascontiguousarray(sos[:, :3].T), np.ascontiguousarray(sos[:, 3:].T)
    got = biquad.biquad_freqz(torch.from_numpy(b), torch.from_numpy(a), nfft).numpy()
    want = np.asarray(jax_biquad.biquad_freqz(jnp.asarray(b), jnp.asarray(a), nfft))
    assert max_rel(got, want) <= FREQZ_TOL[nfft] and max_rel(got, exact) <= FREQZ_F64_TOL
    one = biquad.biquad_freqz(torch.from_numpy(b[:, 0]), torch.from_numpy(a[:, 0]), nfft).numpy()
    want = np.asarray(jax_biquad.biquad_freqz(jnp.asarray(b[:, 0]), jnp.asarray(a[:, 0]), nfft))
    assert max_rel(one, want) <= FREQZ_TOL[nfft]


def test_activations_match_jax():
    """softplus and scaled_softplus within 1e-6 relative, element by element;
    tan_sigmoid too where tan is well conditioned (|x| <= 2). Near tan's pole
    (sigmoid -> 1) an ulp of the sigmoid moves tan by up to 0.6 % in both
    packages (their exps differ by an ulp on some inputs); there the port's
    value is no further from the float64 value than JAX's, plus 1e-6."""
    x = np.random.RandomState(4).randn(1000).astype(np.float32) * 4.0
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for got, want in ((dnn.softplus(xt), jax_dnn.softplus(xj)),
                      (dnn.scaled_softplus(xt, 0.2, 3.0), jax_dnn.scaled_softplus(xj, 0.2, 3.0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for scale in (1.0, 0.3):
        got = dnn.tan_sigmoid(xt, scale).numpy().astype(np.float64)
        want = np.asarray(jax_dnn.tan_sigmoid(xj, scale)).astype(np.float64)
        exact = np.tan(np.pi * 0.5 / (1.0 + np.exp(-scale * x.astype(np.float64))))
        calm = np.abs(scale * x) <= 2.0
        np.testing.assert_allclose(got[calm], want[calm], rtol=1e-6)
        assert np.all(np.abs(got - exact) <= np.abs(want - exact) + 1e-6 * np.abs(exact))


def test_absorption_to_gain_per_sample_matches_jax():
    delays = [1009, 1499, 1999, 2503]
    for dims, coeff in (((4.0, 8.0, 3.0), 0.2), ((6.0, 3.0), 0.05)):
        rt60, gains = absorption.absorption_to_gain_per_sample(dims, coeff, delays, FS)
        ref_rt60, ref_gains = jax_absorption.absorption_to_gain_per_sample(dims, coeff, delays, FS)
        assert abs(rt60 - ref_rt60) <= 1e-6 * ref_rt60
        np.testing.assert_allclose(gains, ref_gains, rtol=1e-6)


def _datasets(num_src: int):
    """(JAX dataset, port dataset) of ``num_src`` sources over 3 receivers."""
    rng = np.random.RandomState(num_src)
    rirs = rng.randn(*((num_src,) if num_src > 1 else ()), 3, 400).astype(np.float32)
    kw = dict(num_rooms=1, sample_rate=8000.0, source_position=rng.rand(num_src, 3) * 3,
              receiver_position=rng.rand(3, 3) * 4, rirs=rirs,
              common_decay_times=np.array([0.05]), room_dims=[(4.0, 4.0, 3.0)],
              room_start_coord=[(0.0, 0.0, 0.0)], nfft=512, grid_spacing_m=1.0)
    return JaxRoomDataset(**kw), RoomDataset(**kw)


def test_frequency_bins_and_mutators_equal_jax():
    jroom, room = _datasets(1)
    np.testing.assert_array_equal(room.freq_bins_hz, jroom.freq_bins_hz)
    rir = np.random.RandomState(1).randn(300).astype(np.float32)
    for kw in (dict(nfft=1024), dict(common_decay_times=np.array([0.04, 0.09]))):
        got = RIRData(rir=rir, sample_rate=8000.0, **{"common_decay_times": np.array([0.1]),
                                                       **kw}).freq_bins_hz
        want = JaxRIRData(rir=rir, sample_rate=8000.0, **{"common_decay_times": np.array([0.1]),
                                                           **kw}).freq_bins_hz
        np.testing.assert_array_equal(got, want)
    for r in (jroom, room):
        r.rir_mag_response  # cache the old RIRs' spectra
    new_pos = np.random.RandomState(2).rand(5, 3)
    new_rirs = np.random.RandomState(3).randn(5, 256)
    for r in (jroom, room):
        r.update_receiver_pos(new_pos)
        r.update_rirs(new_rirs)
    assert room.num_rec == jroom.num_rec == 5 and room.rir_length == jroom.rir_length == 256
    np.testing.assert_array_equal(room.receiver_position, jroom.receiver_position)
    np.testing.assert_array_equal(room.rirs32, jroom.rirs32)
    assert room.rirs32.dtype == np.float32
    np.testing.assert_array_equal(room.rir_mag_response, jroom.rir_mag_response)
    np.testing.assert_array_equal(room.early_rir_time, jroom.early_rir_time)


@pytest.mark.parametrize("num_src", [1, 2])
def test_save_individual_irs_equals_jax(tmp_path, num_src):
    jroom, room = _datasets(num_src)
    jroom.save_individual_irs(tmp_path / "jax", filename_prefix="rir")
    room.save_individual_irs(tmp_path / "port", filename_prefix="rir")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 3 * num_src
    for name in names:
        got, fs = read_wav(tmp_path / "port" / name)
        want, ref_fs = read_wav(tmp_path / "jax" / name)
        assert fs == ref_fs == 8000.0
        np.testing.assert_array_equal(got, want)


def _normalize(x):
    """Enums as values and tuples as lists, as in pydantic's JSON dump."""
    if isinstance(x, dict):
        return {k: _normalize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normalize(v) for v in x]
    return x.value if isinstance(x, Enum) else x


def _jax_dump(cfg) -> dict:
    """JAX's config without its computed fields, as the port's dataclasses."""
    data = cfg.model_dump(mode="json")
    for key in ("delay_length_samps", "load_fixed_parameters", "network_type"):
        data.pop(key, None)
        for sub in data.values():
            if isinstance(sub, dict):
                sub.pop(key, None)
    return data


def _same(port, ref) -> None:
    assert _normalize(dataclasses.asdict(port)) == _normalize(_jax_dump(ref))


def test_preset_library_equals_jax():
    ours, ref = presets.preset_library(), jax_presets.preset_library()
    assert list(ours) == list(ref)
    for name in ref:
        _same(ours[name](), ref[name]())


@pytest.mark.parametrize("factory,args", [
    ("fullband_grid", dict(dataset="data/grid.pkl", out="runs/fb")),
    ("subband_band", dict(freq=300.0, dataset="d/b_{freq}.pkl", out="runs/sb")),
    ("directional_band", dict(freq=2000.0, grid_resolution_m=0.9, dataset="d/s_{freq}.pkl",
                              out="runs/dir")),
    ("spatial_band", dict(freq=250.0, directional=False, dataset="d/x.pkl", out="runs/cs")),
    ("spatial_band", dict(freq=500.0, cnn=True, out="runs/cnn")),
    ("single_rir_fit", dict(variant="freq_dep_colorless_loss", dataset_root="d", out="runs/s")),
    ("synth_grid", dict(variant="subband_single_room", dataset_root="d", out="runs/g")),
])
def test_preset_factories_equal_jax_with_other_paths(factory, args):
    _same(getattr(presets, factory)(**args), getattr(jax_presets, factory)(**args))


def test_factories_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="directional"):
        presets.spatial_band(500.0, directional=False, cnn=True)
    with pytest.raises(ValueError, match="variant"):
        presets.synth_grid("no_such_variant")


@pytest.mark.parametrize("svf,error", [(False, TypeError), (True, AttributeError)],
                         ids=["scalar_heads", "svf_heads"])
def test_single_position_time_domain_fails_in_jax_and_is_refused_c22(tmp_path, svf, error):
    """ROADMAP C22: JAX's synthesis calls the model's ``output_scalars`` (a
    parameter of ``DiffGFDNSinglePos``) or ``output_filters`` (which it
    lacks); the port raises ``ValueError`` naming C22 before any work."""
    _, jmodel, params, model, batch, _ = single_pos_models(
        single_pos_raw(tmp_path, svf, False), tmp_path)
    with pytest.raises(error):
        synth = jax_make_time_domain_synthesis_fn(jmodel, params, 1024)
        synth({k: batch[k] for k in ("listener_position", "norm_listener_position")})
    with pytest.raises(ValueError, match="ROADMAP C22"):
        make_time_domain_synthesis_fn(model, 1024)
