"""Slice-level parity: serving RIRs from one checkpoint in both packages.

JAX ``init_with_batch`` -> ``save_checkpoint`` -> JAX ``InferDiffGFDN.rirs_at``
against the port's ``InferDiffGFDN(..., device="cpu").rirs_at`` reading the
same checkpoint, for both slice configurations (SVF heads with GEQ
absorption; scalar heads with scalar absorption) at fs 8 kHz, nfft 2^14.
Bounds: relative L2 error of the RIRs <= 1e-3 (all samples, and the
reverberant part from the 20 ms mixing time to 0.5 s on its own), Schroeder
EDC within 0.01 dB over the first 0.5 s.
"""

import numpy as np
import pytest

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.inference import InferDiffGFDN
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.inference import InferDiffGFDN as JaxInferDiffGFDN
from diffgfdn_tpu.training.checkpoints import save_checkpoint
from torch_port_helpers import edc_db, FS, jax_model_and_params, raw_config, rel_l2, rooms

NFFT = 2 ** 14
BATCH = 4
RIR_TOL = 1e-3
EDC_TOL_DB = 0.01


@pytest.mark.parametrize(
    "svf,alias_db",
    [(True, None), (False, None), (False, 20)],
    ids=["svf_geq", "scalar", "scalar_reduced_pole_radius"],
)
def test_served_rirs_match_jax(tmp_path, svf, alias_db):
    """``alias_db`` samples H on |z| = 1/rho > 1 and undoes it with a growing
    exponential after the irfft (the reduced-pole-radius envelope). The
    envelope also amplifies float32 irfft rounding, in both packages alike
    (up to ``alias_db`` at the end of the buffer); at 20 dB the first 0.5 s
    stays well above it."""
    raw = raw_config(tmp_path, svf, nfft=NFFT, batch=BATCH)
    raw["trainer_config"]["alias_attenuation_db"] = alias_db
    jax_room, port_room = rooms(tmp_path, svf, NFFT)
    jax_cfg = JaxDiffGFDNConfig.model_validate(raw)
    _, params = jax_model_and_params(jax_cfg, jax_room, BATCH, inference_solve=True)
    save_checkpoint(jax_cfg.trainer_config.train_dir, -1, params)

    idx = np.arange(9)  # two full batches and a padded one
    ref = JaxInferDiffGFDN(jax_cfg, jax_room).rirs_at(idx, batch_size=BATCH)
    rirs = InferDiffGFDN(DiffGFDNConfig.from_dict(raw), port_room, device="cpu").rirs_at(
        idx, batch_size=BATCH
    )
    assert rirs.shape == ref.shape == (len(idx), NFFT)
    assert np.isfinite(rirs).all()
    mix, half_s = int(0.02 * FS), int(0.5 * FS)
    assert rel_l2(rirs, ref) <= RIR_TOL
    # the reverberant part alone, over the window the EDC check reads
    assert rel_l2(rirs[:, mix:half_s], ref[:, mix:half_s]) <= RIR_TOL
    assert np.abs(edc_db(rirs) - edc_db(ref))[:, :half_s].max() <= EDC_TOL_DB


def test_serving_reads_only_the_model_inputs(tmp_path):
    """A served batch carries the model's inputs only; the late and full
    target planes, which the model never reads, are never built."""
    from diffgfdn_torch.inference.gfdn_inference import MODEL_INPUTS
    from diffgfdn_torch.training import build_gfdn_model
    from diffgfdn_torch.utils.params import jax_params_from_torch

    raw = raw_config(tmp_path, svf=False, nfft=1024)
    _, port_room = rooms(tmp_path, False, 1024)
    cfg = DiffGFDNConfig.from_dict(raw)
    params = jax_params_from_torch(build_gfdn_model(cfg, port_room.common_decay_times,
                                                    device="cpu"))
    infer = InferDiffGFDN(cfg, port_room, params=params, device="cpu")
    batch = infer._device_batch(np.array([1, 4]))
    assert set(batch) == set(MODEL_INPUTS)
    assert batch["target_early_response"].shape == (2, 513)
    assert batch["z_values"].shape == (513,)
    assert np.isfinite(infer.rirs_at(np.arange(3), batch_size=2)).all()
    for key in ("target_late_response", "target_rir_response"):
        assert callable(infer.arrays._spectra[key])


def test_missing_checkpoint_raises(tmp_path):
    raw = raw_config(tmp_path, svf=False, nfft=1024)
    _, port_room = rooms(tmp_path, False, 1024)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        InferDiffGFDN(DiffGFDNConfig.from_dict(raw), port_room, device="cpu")


def test_subband_configs_raise_naming_the_roadmap_item(tmp_path):
    """A subband config serves (ROADMAP A11, ported: its RIRs carry the band
    filter's energy compensation); what is left raises naming its item: the
    octave-band merge of source-conditioned models (A10). (The directional
    merge is ported: tests/test_torch_directional_octave_bands.py.)"""
    from diffgfdn_torch.inference import infer_all_octave_bands
    from diffgfdn_torch.training import build_gfdn_model
    from diffgfdn_torch.utils.params import jax_params_from_torch

    raw = raw_config(tmp_path, svf=False, nfft=1024)
    raw["trainer_config"]["subband_process_config"] = {
        "centre_frequency": 500.0, "frequency_range": [63.0, 4000.0]
    }
    _, port_room = rooms(tmp_path, False, 1024)
    cfg = DiffGFDNConfig.from_dict(raw)
    params = jax_params_from_torch(build_gfdn_model(cfg, port_room.common_decay_times,
                                                    device="cpu"))
    infer = InferDiffGFDN(cfg, port_room, params=params, device="cpu")
    assert 0.0 < infer.subband_filter_norm_factor < 1.0
    plain = InferDiffGFDN(DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], subband_process_config=None))),
        port_room, params=params, device="cpu")
    np.testing.assert_allclose(infer.rirs_at([0, 1]),
                               infer.subband_filter_norm_factor * plain.rirs_at([0, 1]),
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        infer_all_octave_bands([cfg], port_room, [0], variant="var_source_receiver",
                               device="cpu")
