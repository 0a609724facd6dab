"""Common-slopes synthesis against the JAX package on JAX's own noise: the
noise each JAX function draws is drawn here at the same keys
(``jax.random.normal``) and fed to the port, which draws from a
``torch.Generator`` otherwise. Every result within 1e-5 relative L2.
"""

import jax
import numpy as np
import pytest
import torch

from diffgfdn_torch.inference import cs_synthesis as port
from diffgfdn_torch.inference import get_ambisonic_rirs
from diffgfdn_torch.ops.sph import modal_weights
from diffgfdn_tpu.config.schema import BeamformerType
from diffgfdn_tpu.inference import cs_synthesis as ref
from diffgfdn_tpu.inference.spatial_inference import get_ambisonic_rirs as jax_ambisonic_rirs
from torch_port_helpers import cs_room_path, cs_rooms, rel_l2

TOL = 1e-5
FS = 8000.0
BANDS = [250.0, 500.0, 1000.0, 2000.0]
P, S, T, FIR = 6, 3, 1600, 2 ** 12
AMBI_ORDER = 2


def _decays():
    return (np.array([0.05, 0.09, 0.07])[:, None] * np.linspace(1.3, 0.7, len(BANDS))
            ).astype(np.float32)  # (S, B)


def _amps(shape, seed):
    return np.random.RandomState(seed).uniform(0.05, 1.0, shape).astype(np.float32)


def _directions():
    from diffgfdn_torch.ops.sph import t_design_directions

    dirs = t_design_directions(5)
    return np.stack([dirs[0], np.pi / 2 - dirs[1]])  # (azimuth, elevation)


def _jax_noise(key, shape):
    return np.array(jax.random.normal(key, shape))  # a writable copy for torch.from_numpy


def _check(got, want, record_property, name):
    err = rel_l2(np.asarray(got), np.asarray(want))
    record_property(f"{name}_rel_l2", err)
    assert np.asarray(got).shape == np.asarray(want).shape
    assert err <= TOL, (name, err)


def test_filter_band_noise_matches_band_noise(record_property):
    filters = port.octave_band_filters(BANDS, FS, FIR)
    assert np.array_equal(filters, ref.reconstructing_fractional_octave_bands(
        1, (min(BANDS), max(BANDS)), FIR, FS)[0])
    key = jax.random.PRNGKey(3)
    want = ref.band_noise(key, (P,), T, filters)
    noise = torch.from_numpy(_jax_noise(key, (P, len(BANDS), T)))
    got = port.filter_band_noise(noise, torch.as_tensor(filters, dtype=torch.float32))
    _check(got, want, record_property, "filter_band_noise")


@pytest.mark.parametrize("per_band", [True, False], ids=["per_band_decays", "broadband"])
def test_shaped_wgn_multiband_matches_jax(per_band, record_property):
    decays = _decays() if per_band else _decays()[:, 0]
    amps = _amps((P, S, len(BANDS)), 1)
    key = jax.random.PRNGKey(5)
    want = ref.shaped_wgn_multiband(decays, amps, FS, T, BANDS, key, FIR)
    noise = torch.from_numpy(_jax_noise(key, (P, len(BANDS), T)))
    got = port.shaped_wgn_multiband(decays, torch.from_numpy(amps), FS, T, BANDS, noise=noise,
                                    fir_len=FIR)
    _check(got, want, record_property, "shaped_wgn")


@pytest.mark.parametrize("method", ["Hold", "custom"])
def test_spatial_bandlimiting_matches_jax(method, record_property):
    des_dir = _directions()
    c_n = modal_weights(BeamformerType.MAX_DI, AMBI_ORDER)
    drirs = np.random.RandomState(2).randn(12, P, T).astype(np.float32)
    want = ref.spatial_bandlimiting(AMBI_ORDER, des_dir, drirs, c_n, method)
    got = port.spatial_bandlimiting(AMBI_ORDER, des_dir, torch.from_numpy(drirs), c_n, method)
    _check(got, want, record_property, f"bandlimiting_{method}")


@pytest.mark.parametrize("bandlimit", [False, True], ids=["plain", "bandlimited"])
def test_convert_directional_rirs_to_ambisonics_matches_jax(bandlimit, record_property):
    des_dir = _directions()
    drirs = np.random.RandomState(4).randn(12, P, T).astype(np.float32)
    want = ref.convert_directional_rirs_to_ambisonics(
        AMBI_ORDER, des_dir, BeamformerType.MAX_DI, drirs, apply_spatial_bandlimiting=bandlimit)
    got = port.convert_directional_rirs_to_ambisonics(
        AMBI_ORDER, des_dir, BeamformerType.MAX_DI, torch.from_numpy(drirs),
        apply_spatial_bandlimiting=bandlimit)
    _check(got, want, record_property, "to_ambisonics")


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
@pytest.mark.parametrize("layout", ["dataset", "slopes_bands", "broadband"])
def test_rirs_from_common_slopes_model_match_jax(directional, layout, record_property):
    """The decay-time layouts: (bands, slopes) as the dataset stores them,
    (slopes, bands), and broadband (slopes,)."""
    seed, des_dir = 11, _directions()
    cdt = {"dataset": _decays().T, "slopes_bands": _decays(), "broadband": _decays()[:, 0]}[layout]
    shape = (P, 12, S, len(BANDS)) if directional else (P, S, len(BANDS))
    amps = _amps(shape, 6)
    kw = dict(ambi_order=AMBI_ORDER, des_directions=des_dir,
              beamformer_type=BeamformerType.MAX_DI) if directional else {}
    pos = np.zeros((P, 3))
    want = ref.get_rirs_from_common_slopes_model(FS, pos, BANDS, T, amps, cdt, seed=seed, **kw)
    key = jax.random.PRNGKey(seed)
    if directional:  # JAX draws direction j from fold_in(key, j)
        noise = np.stack([_jax_noise(jax.random.fold_in(key, j), (P, len(BANDS), T))
                          for j in range(12)])
    else:
        noise = _jax_noise(key, (P, len(BANDS), T))
    got = port.get_rirs_from_common_slopes_model(FS, pos, BANDS, T, torch.from_numpy(amps), cdt,
                                                 noise=torch.from_numpy(noise), **kw)
    _check(got, want, record_property, "cs_rirs")


def test_mismatched_decay_layout_raises():
    with pytest.raises(ValueError, match="common_decay_times"):
        port.get_rirs_from_common_slopes_model(FS, np.zeros((P, 3)), BANDS, T,
                                               torch.ones(P, S, len(BANDS)), np.ones((2, 5)))


def test_calculate_energy_envelope_matches_jax(record_property):
    sig = np.random.RandomState(8).randn(3, 2, T).astype(np.float32) * np.exp(
        -np.arange(T) / 400.0).astype(np.float32)
    want = ref.calculate_energy_envelope(sig, FS)
    got = port.calculate_energy_envelope(torch.from_numpy(sig), FS)
    _check(got, want, record_property, "energy_envelope")


@pytest.mark.parametrize("directional", [True, False], ids=["directional", "omni"])
def test_ambisonic_rirs_from_stored_amplitudes_match_jax(tmp_path, directional, monkeypatch,
                                                         record_property):
    """``get_ambisonic_rirs`` from the dataset's amplitudes, the port's draw
    replaced by JAX's noise at JAX's keys."""
    jax_room, room = cs_rooms(cs_room_path(tmp_path))
    if not directional:
        for r in (jax_room, room):
            r.amplitudes = r.amplitudes.mean(axis=1)
            r.sph_directions = None
    rec = room.receiver_position[::17]
    seed = 4
    want = jax_ambisonic_rirs(rec, jax_room, seed=seed)
    key = jax.random.PRNGKey(seed)

    def jax_draw(shape, generator, device):
        if len(shape) == 4:
            return torch.from_numpy(np.stack([_jax_noise(jax.random.fold_in(key, j), shape[1:])
                                              for j in range(shape[0])]))
        return torch.from_numpy(_jax_noise(key, shape))

    monkeypatch.setattr(port, "draw_noise", jax_draw)
    out = get_ambisonic_rirs(rec, room, seed=seed, device="cpu")
    assert np.array_equal(out.receiver_position, want.receiver_position)
    assert out.rir_length == want.rir_length and out.num_rec == len(rec)
    assert room.num_rec != len(rec)  # the input dataset is not changed
    _check(out.rirs, want.rirs, record_property, "ambisonic_rirs")
