"""Model-level parity of time-domain synthesis and the other inference entry points.

The JAX model's parameters (fs 8 kHz, narrow heads) are carried into the port
(``utils/params.py``); both packages then synthesize from the same receivers:

* ``make_time_domain_synthesis_fn``, port vs JAX, for scalar heads with scalar
  absorption (kernel B7's plain version on the CPU) and SVF heads with GEQ
  absorption (the exact filtered path): 1e-4 x peak;
* the port's own time-domain path vs its frequency path (irfft of H, no
  direct part) at nfft 8192 and decay times of about 0.5 s: short enough
  that the frequency path's time aliasing is negligible, long enough that
  the first 0.4 s stay far above its float32 rounding floor (z^m, irfft):
  2e-3 x peak, and mean |delta EDC| <= 1e-3 dB over 0.4 s for the filtered
  case;
* ``InferDiffGFDN.rirs_with_amplitudes`` vs JAX with the serving bounds of
  ``test_torch_inference.py`` (rel L2 1e-3, EDC 0.01 dB over 0.5 s), and
  ``head_outputs`` vs JAX (1e-5 relative);
* the numpy subband helpers vs JAX.
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.inference import (
    InferDiffGFDN,
    make_rir_synthesis_fn,
    make_time_domain_synthesis_fn,
    merge_subband_rirs,
    subband_energy_compensation,
)
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.utils.params import load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.inference import gfdn_inference as jinf
from diffgfdn_tpu.training.checkpoints import save_checkpoint
from torch_port_helpers import edc_db, FS, jax_model_and_params, raw_config, rel_l2, rooms

NUM_SAMPLES = 4096
BATCH = 4
JAX_TOL = 1e-4      # port vs JAX, max |delta| / peak
FREQ_TOL = 2e-3     # time-domain vs frequency path, max |delta| / peak
EDC_MEAN_TOL_DB = 1e-3
RIR_TOL = 1e-3      # served RIRs, port vs JAX, relative L2
EDC_TOL_DB = 0.01
FREQ_NFFT = 8192  # the frequency-path comparison: a 1 s buffer
FREQ_DECAYS = (0.45, 0.55, 0.5)


def _models(tmp_path, svf: bool, nfft: int = NUM_SAMPLES, decays=None):
    """(JAX model, JAX params, port model, JAX room, port room, raw config)."""
    raw = raw_config(tmp_path, svf, nfft=nfft, batch=BATCH)
    jax_room, port_room = rooms(tmp_path, svf, nfft)
    if decays is not None:
        for room in (jax_room, port_room):
            cdt = np.asarray(room.common_decay_times)
            room.common_decay_times = (
                np.asarray(decays)[None] * np.linspace(1.2, 0.8, cdt.shape[0])[:, None]
                if cdt.ndim == 2 else np.asarray(decays)
            )
    jax_cfg = JaxDiffGFDNConfig.model_validate(raw)
    jmodel, params = jax_model_and_params(jax_cfg, jax_room, BATCH, inference_solve=True)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                             device="cpu")
    load_jax_params(model, params)
    return jmodel, params, model, jax_room, port_room, raw


def _positions(room, idx):
    pos = room.receiver_position[idx].astype(np.float32)
    return {"listener_position": pos,
            "norm_listener_position": room.norm_receiver_position[idx].astype(np.float32)}


def _port_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("svf", [False, True], ids=["scalar_heads", "svf_heads_geq"])
def test_time_domain_synthesis_matches_jax(tmp_path, svf, record_property):
    jmodel, params, model, jax_room, port_room, _ = _models(tmp_path, svf)
    batch = _positions(port_room, np.arange(BATCH))
    ref = np.asarray(jinf.make_time_domain_synthesis_fn(jmodel, params, NUM_SAMPLES)(
        dict(batch, z_values=np.ones(1, np.complex64))))
    rirs = make_time_domain_synthesis_fn(model, NUM_SAMPLES)(_port_batch(batch)).numpy()
    assert rirs.shape == ref.shape == (BATCH, NUM_SAMPLES) and np.isfinite(rirs).all()
    err = float(np.abs(rirs - ref).max() / np.abs(ref).max())
    record_property("max_abs_over_peak_vs_jax", err)
    assert err <= JAX_TOL


@pytest.mark.parametrize("svf", [False, True], ids=["scalar_heads", "svf_heads_geq"])
def test_time_domain_synthesis_matches_frequency_path(tmp_path, svf, record_property):
    _, _, model, _, port_room, _ = _models(tmp_path, svf, FREQ_NFFT, FREQ_DECAYS)
    batch = _port_batch(_positions(port_room, np.arange(BATCH)))
    rirs = make_time_domain_synthesis_fn(model, FREQ_NFFT)(batch).numpy()
    z = np.exp(1j * port_room.freq_bins_rad).astype(np.complex64)
    freq = make_rir_synthesis_fn(model)(dict(batch, z_values=torch.from_numpy(z))).numpy()
    peak = np.abs(freq).max()
    err = float(np.abs(rirs - freq).max() / peak)
    end = int(0.4 * FS)
    edc_err = float(np.mean(np.abs(edc_db(rirs[:, :end]) - edc_db(freq[:, :end]))))
    record_property("max_abs_over_peak_vs_frequency_path", err)
    record_property("mean_abs_edc_db_vs_frequency_path", edc_err)
    assert err <= FREQ_TOL
    if svf:  # the filtered (GEQ absorption) case
        assert edc_err <= EDC_MEAN_TOL_DB


def _inferers(tmp_path, svf: bool):
    jmodel, params, _, jax_room, port_room, raw = _models(tmp_path, svf)
    jax_cfg = JaxDiffGFDNConfig.model_validate(raw)
    save_checkpoint(jax_cfg.trainer_config.train_dir, -1, params)
    return (jinf.InferDiffGFDN(jax_cfg, jax_room),
            InferDiffGFDN(DiffGFDNConfig.from_dict(raw), port_room, device="cpu"))


def test_rirs_with_amplitudes_match_jax(tmp_path):
    jax_infer, infer = _inferers(tmp_path, svf=False)
    idx = np.arange(6)  # a full batch and a padded one
    amps = np.random.RandomState(0).uniform(-1.0, 1.0, (len(idx), 3)).astype(np.float32)
    ref = jax_infer.rirs_with_amplitudes(idx, amps, batch_size=BATCH)
    rirs = infer.rirs_with_amplitudes(idx, amps, batch_size=BATCH)
    assert rirs.shape == ref.shape == (len(idx), NUM_SAMPLES)
    assert rel_l2(rirs, ref) <= RIR_TOL
    assert np.abs(edc_db(rirs) - edc_db(ref))[:, : int(0.5 * FS)].max() <= EDC_TOL_DB
    # the amplitudes, not the head, set the output
    assert not np.allclose(rirs, infer.rirs_at(idx, batch_size=BATCH))
    with pytest.raises(ValueError, match="shape"):
        infer.rirs_with_amplitudes(idx, amps[:, :2])


@pytest.mark.parametrize("svf", [False, True], ids=["scalar_heads", "svf_heads"])
def test_head_outputs_match_jax(tmp_path, svf):
    jax_infer, infer = _inferers(tmp_path, svf)
    idx = np.array([0, 3, 5])
    ref = jax_infer.head_outputs(idx)
    out = infer.head_outputs(idx)
    assert set(out) == set(ref)
    for key, want in ref.items():
        assert out[key].shape == want.shape, key
        np.testing.assert_allclose(out[key], want, rtol=1e-5, atol=1e-6, err_msg=key)
    if svf:
        with pytest.raises(ValueError, match="scalar-head"):
            infer.rirs_with_amplitudes(idx, np.zeros((3, 3), np.float32))


def test_directional_models_raise_naming_the_roadmap_item():
    """The GFDN variants still to port raise naming ROADMAP A10; the
    directional model now synthesizes (test_torch_directional_inference.py)."""
    class DiffGFDNVarSourceReceiverPos(torch.nn.Module):
        pass

    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        make_time_domain_synthesis_fn(DiffGFDNVarSourceReceiverPos(), NUM_SAMPLES)


def test_subband_helpers_match_jax():
    rng = np.random.RandomState(1)
    band_rirs = [rng.randn(2, 3, 500) for _ in range(3)]
    filters = rng.randn(3, 65)
    np.testing.assert_allclose(merge_subband_rirs(band_rirs, filters),
                               jinf.merge_subband_rirs(band_rirs, filters), rtol=1e-12)
    assert subband_energy_compensation(filters[1]) == jinf.subband_energy_compensation(filters[1])
