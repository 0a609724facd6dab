"""The int8 target codec against the JAX package (``utils/cio.py:109-163``).

From 64 MiB of float32 target RIRs both packages ship them as per-256-sample
int8 blocks and dequantize them on the device; every target feature is
computed from the dequantized RIRs. The threshold is lowered with
``monkeypatch`` in both packages' modules so that a small synthetic grid
(fs 8 kHz, 9 receivers, 0.5 s, nfft 2^12) crosses it. Bounds: the codec's
q, scales and length equal to JAX's; the uploaded targets within 1e-7 of
the largest value of JAX's ``device_target_rir_time``; the precomputed EDC
within 0.01 dB of JAX's (the slice's EDC bound) and the EDR's mean within
1e-3 dB; below the threshold the targets are the exact float32 RIRs.
"""

import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_room_dataset
from diffgfdn_torch.training import build_gfdn_model, GFDNTrainer
from diffgfdn_torch.training.trainer import target_rirs
from diffgfdn_torch.utils import cio
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.training.build import build_gfdn_model as jax_build_gfdn_model
from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer
from diffgfdn_tpu.utils import cio as jax_cio
from torch_port_helpers import raw_config, rooms

NFFT = 2 ** 12
TARGET_TOL = 1e-7  # of the largest value
EDC_TOL_DB = 0.01
EDR_MEAN_TOL_DB = 1e-3


@pytest.fixture
def lowered(monkeypatch):
    """Both packages quantize from 1 KiB."""
    monkeypatch.setattr(jax_cio, "_QUANT_MIN_BYTES", 1024)
    monkeypatch.setattr(cio, "QUANT_MIN_BYTES", 1024)


def test_codec_constants_are_jax_s():
    assert cio.QUANT_MIN_BYTES == jax_cio._QUANT_MIN_BYTES == 64 * 1024 * 1024
    assert cio.QUANT_BLOCK == jax_cio._QUANT_BLOCK == 256


@pytest.mark.parametrize("t", [1024, 1000], ids=["whole_blocks", "partial_block"])
def test_quantize_int8_blocks_equals_jax(t):
    rng = np.random.RandomState(4)
    x = (rng.randn(5, t) * np.exp(-np.arange(t) / 300.0)[None]).astype(np.float32)
    x[1, 256:512] = 0.0  # an all-zero block
    q, scale, length = cio.quantize_int8_blocks(x)
    jq, jscale, jlength = jax_cio.quantize_int8_blocks(x)
    assert length == jlength == t
    assert q.dtype == np.int8 and np.array_equal(q, jq)
    assert scale.dtype == np.float32 and np.array_equal(scale, jscale)
    back = cio.dequantize_int8_blocks(torch.from_numpy(q), torch.from_numpy(scale), t).numpy()
    assert back.shape == x.shape and not back[1, 256:512].any()
    # half a step of each block at most
    step = np.repeat(scale[..., 0], 256, axis=-1)[:, :t]
    assert np.all(np.abs(back - x) <= 0.5 * step * (1 + 1e-6))


def _data(tmp_path):
    raw = raw_config(tmp_path, svf=False, nfft=NFFT)
    jax_room, port_room = rooms(tmp_path, False, NFFT)
    return raw, jax_room, port_room


def test_targets_above_the_threshold_equal_jax(tmp_path, lowered, record_property):
    _, jax_room, port_room = _data(tmp_path)
    want = np.asarray(jax_cio.device_target_rir_time(jax_arrays(jax_room)))
    exact = port_room.rirs32
    t = exact.shape[-1]
    got = target_rirs(arrays_from_room_dataset(port_room), t, torch.device("cpu")).numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    record_property("targets_max_abs_over_peak", err)
    assert got.shape == want.shape == exact.shape
    assert err <= TARGET_TOL
    assert np.abs(got - exact).max() > 0.0  # quantized, not exact


def test_targets_below_the_threshold_are_exact(tmp_path):
    _, _, port_room = _data(tmp_path)
    exact = port_room.rirs32
    assert exact.nbytes < cio.QUANT_MIN_BYTES
    got = target_rirs(arrays_from_room_dataset(port_room), NFFT, torch.device("cpu")).numpy()
    t = min(NFFT, exact.shape[-1])
    assert np.array_equal(got[:, :t], exact[:, :t]) and not got[:, t:].any()


def test_target_features_from_quantized_targets_match_jax(tmp_path, lowered, record_property):
    raw, jax_room, port_room = _data(tmp_path)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    jmodel = jax_build_gfdn_model(jcfg, common_decay_times=jax_room.common_decay_times,
                                  band_centre_hz=jax_room.band_centre_hz,
                                  use_pallas_inverse=False)
    jtrainer = JaxGFDNTrainer(jmodel, jcfg.trainer_config, 1,
                              common_decay_times=jax_room.common_decay_times,
                              sample_rate=jcfg.sample_rate)
    arrays = jax_arrays(jax_room)
    jtrainer.precompute_target_features(arrays)
    want = {k: np.asarray(v) for k, v in arrays.precomputed.items()}

    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, port_room.common_decay_times, device="cpu")
    trainer = GFDNTrainer(model, cfg.trainer_config, 1,
                          common_decay_times=port_room.common_decay_times,
                          sample_rate=cfg.sample_rate, device="cpu")
    trainer.precompute_target_features(arrays_from_room_dataset(port_room))
    got = {k: v.numpy() for k, v in trainer.features.items()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    edc_err = float(np.abs(got["target_edc_db"] - want["target_edc_db"]).max())
    edr_err = float(np.abs(got["target_edr_db"] - want["target_edr_db"]).mean())
    record_property("edc_max_abs_db", edc_err)
    record_property("edr_mean_abs_db", edr_err)
    assert edc_err <= EDC_TOL_DB and edr_err <= EDR_MEAN_TOL_DB
