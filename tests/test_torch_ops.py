"""Port parity for config, DSP ops and host-side design code.

Each test feeds the same numpy inputs (seeded) to the JAX package's function
and to its counterpart in diffgfdn_torch. Host numpy code is copied, so it
must agree to float64 rounding; torch code on float32 tensors to float32
rounding (bounds stated per test).
"""

import dataclasses
from enum import Enum
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffgfdn_torch.config import load_and_validate_config, PRESETS
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.kernels.sos import sos_cascade_response
from diffgfdn_torch.ops import absorption, basic, biquad, geq, unitary
from diffgfdn_tpu.config import load_and_validate_config as jax_load_config
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.ops import absorption as jax_absorption
from diffgfdn_tpu.ops import basic as jax_basic
from diffgfdn_tpu.ops import biquad as jax_biquad
from diffgfdn_tpu.ops import geq as jax_geq
from diffgfdn_tpu.ops import unitary as jax_unitary

ROOT = Path(__file__).resolve().parents[1]
PRESET_FILES = {
    "fullband_grid_colorless": ROOT / "configs/presets/fullband/fullband_grid_colorless.yml",
    "three_room_example": ROOT / "configs/three_room_example.yml",
    **{p.stem: p for p in sorted((ROOT / "configs/presets/subband").glob("subband_*Hz.yml"))},
    "single_rir_example": ROOT / "configs/single_rir_example.yml",
    **{p.stem: p for p in sorted((ROOT / "configs/presets/single_rir").glob("*.yml"))},
    **{p.stem: p for p in sorted((ROOT / "configs/presets/synth").glob("*.yml"))},
}
# computed fields of the JAX schema, not stored in YAML
_COMPUTED = ("delay_length_samps", "load_fixed_parameters", "network_type")


def _jax_dump(cfg) -> dict:
    data = cfg.model_dump(mode="json")
    for key in _COMPUTED:
        data.pop(key, None)
        for sub in data.values():
            if isinstance(sub, dict):
                sub.pop(key, None)
    return data


def _normalize(x):
    """Enums as values and tuples as lists, as in pydantic's JSON dump."""
    if isinstance(x, dict):
        return {k: _normalize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_normalize(v) for v in x]
    return x.value if isinstance(x, Enum) else x


@pytest.mark.parametrize("name", sorted(PRESET_FILES))
def test_presets_equal_their_yaml(name):
    with open(PRESET_FILES[name]) as f:
        assert PRESETS[name] == yaml.safe_load(f)


@pytest.mark.parametrize("name", sorted(PRESET_FILES))
def test_config_loads_like_the_jax_schema(name):
    port = load_and_validate_config(PRESET_FILES[name])
    ref = jax_load_config(PRESET_FILES[name], JaxDiffGFDNConfig)
    assert _normalize(dataclasses.asdict(port)) == _normalize(_jax_dump(ref))
    assert port.delay_length_samps == ref.delay_length_samps


@pytest.mark.parametrize(
    "raw",
    [
        dict(seed=1, sample_rate=32000.0, num_delay_lines=12, delay_range_ms=[20.0, 50.0]),
        dict(seed=46434, sample_rate=48000.0, num_delay_lines=8),
        dict(seed=9, sample_rate=8000.0, num_delay_lines=6, delay_range_ms=[20.0, 45.0]),
        dict(seed=5, ambi_order=2, num_groups=2, delay_range_ms=[10.0, 80.0]),
    ],
)
def test_delay_lengths_match_jax(raw):
    assert (DiffGFDNConfig.from_dict(raw).delay_length_samps
            == JaxDiffGFDNConfig.model_validate(raw).delay_length_samps)


def test_config_rejects_unknown_keys_and_bad_values():
    with pytest.raises(ValueError, match="num_delay_line"):
        DiffGFDNConfig.from_dict({"num_delay_line": 12})
    with pytest.raises(ValueError, match="use_svf"):
        DiffGFDNConfig.from_dict({"output_filter_config": {"use_svf": True}})
    with pytest.raises(ValueError):
        DiffGFDNConfig.from_dict({"feedback_loop_config": {"coupling_matrix_type": "nope"}})
    cfg = DiffGFDNConfig.from_dict(
        {"trainer_config": {"num_freq_bins": 1024, "alias_attenuation_db": 60}}
    )
    assert cfg.trainer_config.reduced_pole_radius == pytest.approx(10 ** (-60 / 1024 / 20))


def test_basic_helpers_match_jax():
    assert basic.ms_to_samps(20.0, 32000.0) == jax_basic.ms_to_samps(20.0, 32000.0)
    np.testing.assert_array_equal(
        basic.ms_to_samps(np.array([5.0, 20.0]), 8000.0),
        jax_basic.ms_to_samps(np.array([5.0, 20.0]), 8000.0),
    )
    for a, b in zip(basic.hann_fade_windows(41), jax_basic.hann_fade_windows(41)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(basic.db2lin_np([-6.0, 3.0]), jax_basic.db2lin_np([-6.0, 3.0]))
    assert basic.LOG10E6 == jax_basic.LOG10E6
    z = basic.get_frequency_samples(257, radius=1.01).numpy()
    z_ref = np.asarray(jax_basic.get_frequency_samples(257, radius=1.01))
    assert np.abs(z - z_ref).max() <= 1e-6


def test_svf_to_biquad_matches_jax():
    rng = np.random.RandomState(0)
    shape = (4, 3, 11)
    cutoff = rng.uniform(0.01, 1.5, shape).astype(np.float32)
    res = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    ftype = rng.randint(0, 6, shape).astype(np.int32)
    g_db = rng.uniform(-6, 6, shape).astype(np.float32)
    num, den = biquad.svf_to_biquad(
        *(torch.from_numpy(x) for x in (cutoff, res, ftype, g_db)), 0.9
    )
    jnum, jden = jax_biquad.svf_to_biquad(cutoff, res, ftype, g_db, 0.9)
    # float32 arithmetic in the same order: a few ulps
    np.testing.assert_allclose(num.numpy(), np.asarray(jnum), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(den.numpy(), np.asarray(jden), rtol=1e-5, atol=1e-6)


def test_cascade_response_matches_jax_sos_frequency_response():
    """kernels.sos.sos_cascade_response (CPU: its plain version) has the
    contract of the JAX package's ops.biquad.sos_frequency_response."""
    rng = np.random.RandomState(1)
    num = rng.randn(5, 11, 3).astype(np.float32)
    den = rng.randn(5, 11, 3).astype(np.float32)
    den[..., 0] += 4.0  # keep the poles inside the unit circle
    z = np.exp(1j * np.linspace(0, np.pi, 333)).astype(np.complex64)
    h = sos_cascade_response(torch.from_numpy(num), torch.from_numpy(den),
                             torch.from_numpy(z)).numpy()
    ref = np.asarray(jax_biquad.sos_frequency_response(num, den, jnp.asarray(z)))
    assert np.abs(h - ref).max() <= 1e-4 * np.abs(ref).max()


def test_geq_and_absorption_design_match_jax():
    bands = np.array([63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0])
    t60 = np.linspace(1.4, 0.6, len(bands))
    delays = np.array([653, 1019, 1531])
    out = absorption.decay_times_to_gain_filters_geq(bands, t60, delays, 32000.0)
    ref = jax_absorption.decay_times_to_gain_filters_geq(bands, t60, delays, 32000.0)
    assert out.shape == (3, len(bands) + 3, 3, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        absorption.decay_times_to_gain_per_sample(0.8, delays, 32000.0),
        np.asarray(jax_absorption.decay_times_to_gain_per_sample(0.8, delays, 32000.0)),
    )
    for a, b in zip(geq.eq_freqs(), jax_geq.eq_freqs()):
        np.testing.assert_array_equal(a, b)


def test_unitary_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 4).astype(np.float32)
    o = unitary.orthogonal_from_skew(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_unitary.orthogonal_from_skew(jnp.asarray(x)))
    np.testing.assert_allclose(o, ref, atol=2e-6)
    np.testing.assert_allclose(o @ o.transpose(0, 2, 1), np.broadcast_to(np.eye(4), o.shape),
                               atol=2e-6)
    for n in (2, 3, 4):
        alpha = rng.uniform(-np.pi, np.pi, n * (n - 1) // 2).astype(np.float32)
        u = unitary.nd_unitary(torch.from_numpy(alpha), n).numpy()
        np.testing.assert_allclose(u, np.asarray(jax_unitary.nd_unitary(jnp.asarray(alpha), n)),
                                   atol=2e-6)
