"""Broadband reconstruction from subband models: the port against the JAX package.

The port trains three bands (500 / 1000 / 2000 Hz, two architecture groups;
fs 8 kHz, nfft 2^12, 24 synthetic receivers with 1.0-1.5 s decays) for one
epoch through ``training_band_parallel`` and writes each band's checkpoint;
both packages then serve from those checkpoints, so each port checkpoint
also loads into JAX's ``InferDiffGFDN``. Bounds, the slice's: relative L2
error of the RIRs <= 1e-3 (all samples, and from the 20 ms mixing time to
0.5 s), Schroeder EDC within 0.01 dB over the first 0.5 s; the per-receiver
broadband EDC errors computed on the device within 0.01 dB of JAX's.
"""

import numpy as np
import pytest

from diffgfdn_torch.cli import run_subband_training as port_cli
from diffgfdn_torch.inference import (
    band_reconstruction_filters,
    broadband_edc_errors_device,
    infer_all_octave_bands,
    InferDiffGFDN,
    merge_subband_rirs,
)
from diffgfdn_tpu.inference import InferDiffGFDN as JaxInferDiffGFDN
from diffgfdn_tpu.inference.gfdn_inference import _band_reconstruction_filters
from diffgfdn_tpu.inference.gfdn_inference import broadband_edc_errors_device as jax_errors
from diffgfdn_tpu.inference.gfdn_inference import infer_all_octave_bands as jax_infer_all
from diffgfdn_tpu.inference.gfdn_inference import merge_subband_rirs as jax_merge
from torch_port_helpers import edc_db, FS, rel_l2, subband_configs, subband_room_path
from torch_port_helpers import subband_rooms

RIR_TOL = 1e-3
EDC_TOL_DB = 0.01
IDX = np.arange(10)  # two full batches of 4 and a padded one


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each band's one-epoch checkpoint from the port's band-parallel CLI path."""
    tmp = tmp_path_factory.mktemp("subband")
    path = subband_room_path(tmp)
    jax_room, port_room = subband_rooms(path)
    with pytest.MonkeyPatch.context() as mp:
        jcfgs, cfgs = subband_configs(mp, path, tmp / "train", max_epochs=1)
    port_cli.training_band_parallel(cfgs, port_room, device="cpu")
    return jcfgs, cfgs, jax_room, port_room


def _check_rirs(rirs, ref):
    assert rirs.shape == ref.shape and np.isfinite(rirs).all()
    mix, half_s = int(0.02 * FS), int(0.5 * FS)
    assert rel_l2(rirs, ref) <= RIR_TOL
    assert rel_l2(rirs[:, mix:half_s], ref[:, mix:half_s]) <= RIR_TOL
    assert np.abs(edc_db(rirs) - edc_db(ref))[:, :half_s].max() <= EDC_TOL_DB


def test_merge_and_reconstruction_filters_match_jax(trained):
    jcfgs, cfgs, _, _ = trained
    for fir_len in (128, 2 ** 12):
        filters = band_reconstruction_filters(cfgs, FS, fir_len)
        np.testing.assert_array_equal(filters, _band_reconstruction_filters(jcfgs, FS, fir_len))
    rng = np.random.RandomState(3)
    band_rirs = [rng.randn(5, 2 ** 12) for _ in cfgs]
    np.testing.assert_allclose(merge_subband_rirs(band_rirs, filters),
                               jax_merge(band_rirs, filters), rtol=0, atol=1e-12)


def test_each_band_serves_as_in_jax_from_the_port_checkpoint(trained):
    jcfgs, cfgs, jax_room, port_room = trained
    for jcfg, cfg in zip(jcfgs, cfgs):
        infer = InferDiffGFDN(cfg, port_room, device="cpu")
        ref_infer = JaxInferDiffGFDN(jcfg, jax_room)
        assert infer.subband_filter_norm_factor == pytest.approx(
            ref_infer.subband_filter_norm_factor, rel=1e-12)
        _check_rirs(infer.rirs_at(IDX[:4], batch_size=4), ref_infer.rirs_at(IDX[:4], 4))


def test_infer_all_octave_bands_matches_jax(trained):
    jcfgs, cfgs, jax_room, port_room = trained
    rirs = infer_all_octave_bands(cfgs, port_room, IDX, device="cpu")
    _check_rirs(rirs, jax_infer_all(jcfgs, jax_room, IDX))


def test_broadband_edc_errors_device_match_jax(trained, record_property):
    jcfgs, cfgs, jax_room, port_room = trained
    errs = broadband_edc_errors_device(cfgs, port_room, IDX, batch_size=4, fir_len=128,
                                       device="cpu")
    ref = jax_errors(jcfgs, jax_room, IDX, batch_size=4, fir_len=128)
    assert errs.shape == ref.shape == IDX.shape and np.isfinite(errs).all()
    record_property("max_abs_db", float(np.max(np.abs(errs - ref))))
    assert np.max(np.abs(errs - ref)) <= EDC_TOL_DB
