"""Serving and time-domain synthesis of DiffDirectionalFDNVarReceiverPos
against the JAX package on the CPU.

JAX's ``InferDiffGFDN(cfg, room, variant="directional")`` cannot build its
model (it passes no directions to the analysis-matrix design: ROADMAP C11),
so the port's class, which builds the model as the directional solver
does, is held to JAX's ``make_rir_synthesis_fn`` on the model that JAX's
solver builds, from the same parameters: SH-domain RIRs (B, 9, nfft) within
1e-3 relative L2 (C7's slice bound). Time domain: against JAX's
``make_time_domain_synthesis_fn`` within 1e-4 of the peak (C5), and against
the port's own frequency path within 2e-3 of the peak (the bound of JAX's
own test), with decays near 0.5 s at nfft 8192, where neither the float32
floor of the irfft nor its time aliasing enters (C5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.inference import (
    InferDiffGFDN,
    make_rir_synthesis_fn,
    make_time_domain_synthesis_fn,
)
from diffgfdn_torch.kernels.tdgfdn import delay_line_outputs
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.inference import gfdn_inference as jinf
from diffgfdn_tpu.utils.cio import encode_batch
from torch_port_helpers import (
    directional_raw_config,
    edc_db,
    jax_directional_model_and_params,
    rel_l2,
    spatial_rooms,
)

IDX = np.array([0, 5, 17, 30, 43])
RIR_TOL = 1e-3
TD_JAX_TOL = 1e-4
TD_FREQ_TOL = 2e-3
TD_SAMPLES = 8192


def _subband(raw: dict) -> dict:
    """The presets' in-loss band: the 1 kHz octave of the 63 Hz - 8 kHz bank."""
    raw["trainer_config"]["subband_process_config"] = dict(
        centre_frequency=1000.0, frequency_range=[63.0, 4000.0], num_fraction_octaves=1,
        use_amp_preserving_filterbank=True)
    return raw


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dir_serve")
    jroom, room = spatial_rooms(tmp)
    raw = _subband(directional_raw_config(tmp, 2))
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    jax_model, params = jax_directional_model_and_params(jcfg, jroom, 4)
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, jax_model, params, DiffGFDNConfig.from_dict(raw), jroom, room


def test_served_srirs_match_jax_synthesis(served, record_property):
    jcfg, jax_model, params, cfg, jroom, room = served
    infer = InferDiffGFDN(cfg, room, variant="directional", params=params, device="cpu")
    rirs = infer.rirs_at(IDX, batch_size=4)
    arrays = jax_arrays(jroom)
    batch = {"z_values": arrays.z_values, "listener_position": arrays.listener_position[IDX],
             "norm_listener_position": arrays.norm_listener_position[IDX]}
    synth = jinf.make_rir_synthesis_fn(jax_model, jcfg.trainer_config.reduced_pole_radius)
    ref = np.asarray(synth(jax.tree_util.tree_map(jnp.asarray, params), encode_batch(batch)))
    factor = infer.subband_filter_norm_factor
    assert 0.0 < factor < 1.0
    filters, centres = jinf.reconstructing_fractional_octave_bands(
        num_fractions=1, frequency_range=[63.0, 4000.0], n_samples=2 ** 12,
        sampling_rate=room.sample_rate)
    band = filters[int(np.argmin(np.abs(centres - 1000.0)))]
    assert factor == jinf.subband_energy_compensation(band)
    nfft = room.num_freq_bins
    assert rirs.shape == (len(IDX), 9, nfft) and np.isfinite(rirs).all()
    err = rel_l2(rirs, factor * ref)
    record_property("rel_l2", err)
    assert err <= RIR_TOL
    # the model's inputs only: the SRIR spectra of the dataset are never computed
    assert callable(infer.arrays._spectra["target_rir_response"])


def test_jax_infer_cannot_build_the_directional_model(served):
    """ROADMAP C11: JAX's class builds the model without the dataset's
    directions, and the analysis-matrix design fails on None."""
    jcfg, _, params, _, jroom, _ = served
    with pytest.raises(TypeError):
        jinf.InferDiffGFDN(jcfg, jroom, variant="directional", params=params)


@pytest.fixture(scope="module")
def td_models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dir_td")
    jroom, room = spatial_rooms(tmp, decay_times=(0.4, 0.5, 0.45))
    raw = directional_raw_config(tmp, 2)
    jax_model, params = jax_directional_model_and_params(
        JaxDiffGFDNConfig.model_validate(raw), jroom, 4)
    params = jax.tree_util.tree_map(np.asarray, params)
    infer = InferDiffGFDN(DiffGFDNConfig.from_dict(raw), room, variant="directional",
                          params=params, device="cpu")
    pos = room.norm_receiver_position[IDX].astype(np.float32)
    batch = {"listener_position": room.receiver_position[IDX].astype(np.float32),
             "norm_listener_position": pos}
    return jax_model, params, infer.model, batch


def test_time_domain_srirs_match_jax(td_models, monkeypatch, record_property):
    jax_model, params, model, batch = td_models
    calls = []
    monkeypatch.setattr("diffgfdn_torch.inference.gfdn_inference.delay_line_outputs",
                        lambda *a: calls.append(a) or delay_line_outputs(*a))
    got = make_time_domain_synthesis_fn(model, TD_SAMPLES)(
        {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    # B7's path: one delay-line run, on the transposed feedback matrix
    (delays, _, a, _, _), = calls
    np.testing.assert_array_equal(a.numpy(),
                                  model.feedback_loop.coupled_feedback_matrix().T.detach().numpy())
    ref = np.asarray(jinf.make_time_domain_synthesis_fn(
        jax_model, jax.tree_util.tree_map(jnp.asarray, params), TD_SAMPLES)(batch))
    assert got.shape == ref.shape == (len(IDX), 9, TD_SAMPLES)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    record_property("max_abs_over_peak", err)
    assert err <= TD_JAX_TOL


def test_time_domain_srirs_match_the_frequency_path(td_models, record_property):
    _, _, model, batch = td_models
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    td = make_time_domain_synthesis_fn(model, TD_SAMPLES)(tb).numpy()
    z = np.exp(1j * np.linspace(0.0, np.pi, TD_SAMPLES // 2 + 1)).astype(np.complex64)
    freq = make_rir_synthesis_fn(model)({**tb, "z_values": torch.from_numpy(z)}).numpy()
    err = float(np.abs(td - freq).max() / np.abs(freq).max())
    edc = float(np.mean(np.abs(edc_db(td) - edc_db(freq))[..., : int(0.4 * model.sample_rate)]))
    record_property("max_abs_over_peak", err)
    record_property("mean_abs_edc_db", edc)
    assert err <= TD_FREQ_TOL and edc <= 0.01
