"""The directional octave-band merge against the JAX package on the CPU.

Three directional band models (500, 1000 and 2000 Hz octaves of the 63 Hz -
4 kHz bank, ambi order 2, a narrow skip-connection MLP) on a synthetic
spatial grid at 8 kHz, nfft 2048. JAX's ``infer_all_octave_bands_directional``
cannot build its models (ROADMAP C11), so the port's merge of each band's
checkpoint is held to JAX's ``merge_subband_rirs`` applied to JAX's
``make_rir_synthesis_fn`` on the models JAX's solver builds, each band
scaled by its energy compensation: relative L2 1e-3 and EDC 0.01 dB (the
slice bounds of C7). ``convert_to_ambisonics=True`` raises ``ValueError``
(ROADMAP C12): the merged SRIRs are SH-domain, and JAX's conversion reads
their channel axis as the 12 directions, which fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.inference import infer_all_octave_bands, infer_all_octave_bands_directional
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.inference import cs_synthesis as jax_cs
from diffgfdn_tpu.inference import gfdn_inference as jinf
from diffgfdn_tpu.training.checkpoints import save_checkpoint
from diffgfdn_tpu.utils.cio import encode_batch
from torch_port_helpers import (
    directional_raw_config,
    edc_db,
    jax_directional_model_and_params,
    rel_l2,
    spatial_rooms,
)

BANDS = (500.0, 1000.0, 2000.0)
SEEDS = (11, 12, 13)
IDX = np.array([0, 5, 17, 30, 43])
RIR_TOL = 1e-3
EDC_TOL_DB = 0.01
FIR_LEN = 2 ** 12


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    """Per band: (JAX config, port config, JAX model, params); the params are
    also each band's checkpoint in its training directory."""
    tmp = tmp_path_factory.mktemp("dir_bands")
    jroom, room = spatial_rooms(tmp, decay_times=(0.1, 0.2, 0.15))
    out = []
    for band, seed in zip(BANDS, SEEDS):
        raw = directional_raw_config(tmp / f"{band:.0f}Hz", 2)
        raw["seed"] = seed
        raw["trainer_config"]["subband_process_config"] = dict(
            centre_frequency=band, frequency_range=[63.0, 4000.0], num_fraction_octaves=1,
            use_amp_preserving_filterbank=True)
        jcfg = JaxDiffGFDNConfig.model_validate(raw)
        jmodel, params = jax_directional_model_and_params(jcfg, jroom, 4)
        params = jax.tree_util.tree_map(np.asarray, params)
        save_checkpoint(jcfg.trainer_config.train_dir, 0, params)
        out.append((jcfg, DiffGFDNConfig.from_dict(raw), jmodel, params))
    return jroom, room, out


def jax_merge(jroom, bands) -> np.ndarray:
    """JAX's merge of JAX's per-band syntheses, each scaled by its band
    filter's energy compensation (as ``InferDiffGFDN.rirs_at`` scales)."""
    arrays = jax_arrays(jroom)
    batch = encode_batch({"z_values": arrays.z_values,
                          "listener_position": arrays.listener_position[IDX],
                          "norm_listener_position": arrays.norm_listener_position[IDX]})
    jcfgs = [b[0] for b in bands]
    filters = jinf._band_reconstruction_filters(jcfgs, jroom.sample_rate, FIR_LEN)
    per_band = []
    for (jcfg, _, jmodel, params), filt in zip(bands, filters):
        synth = jinf.make_rir_synthesis_fn(jmodel, jcfg.trainer_config.reduced_pole_radius)
        rirs = np.asarray(synth(jax.tree_util.tree_map(jnp.asarray, params), batch))
        per_band.append(jinf.subband_energy_compensation(filt) * rirs)
    return jinf.merge_subband_rirs(per_band, filters)


def test_merge_matches_jax(bands, record_property):
    jroom, room, cfgs = bands
    ref = jax_merge(jroom, cfgs)
    got = infer_all_octave_bands_directional([b[1] for b in cfgs], room, IDX, device="cpu")
    nfft = room.num_freq_bins
    assert got.shape == ref.shape == (len(IDX), 9, nfft) and got.dtype == np.float64
    assert np.isfinite(got).all()
    err = rel_l2(got, ref)
    edc = float(np.abs(edc_db(got) - edc_db(ref))[..., : nfft // 2].max())
    record_property("rel_l2", err)
    record_property("edc_max_abs_db", edc)
    assert err <= RIR_TOL
    assert edc <= EDC_TOL_DB
    # the entry point users call takes the same path
    again = infer_all_octave_bands([b[1] for b in cfgs], room, IDX, variant="directional",
                                   device="cpu")
    np.testing.assert_array_equal(again, got)


def test_conversion_to_ambisonics_raises(bands):
    """C12: the port refuses; JAX's conversion of the merged (P, 9, T) SRIRs,
    transposed as its merge passes them, fails on the 12 x 9 synthesis matrix."""
    jroom, room, cfgs = bands
    with pytest.raises(ValueError, match="C12"):
        infer_all_octave_bands_directional([b[1] for b in cfgs], room, IDX,
                                           convert_to_ambisonics=True, device="cpu")
    merged = np.zeros((len(IDX), 9, 16))
    with pytest.raises(ValueError):
        jax_cs.convert_directional_rirs_to_ambisonics(
            jroom.ambi_order, jroom.sph_directions,
            cfgs[0][0].output_filter_config.beamformer_type, merged.transpose(1, 0, 2))
