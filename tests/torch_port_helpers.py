"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from seeds and handed to both packages: the same
synthetic dataset pickle, the same raw config mapping, the same flax
parameters (carried into the port by diffgfdn_torch.utils.params).
"""

import numpy as np

FS = 8000.0
BANDS = [250.0, 500.0, 1000.0, 2000.0]
DECAY_TIMES = (1.0, 1.5, 1.2)  # long enough that the first 0.5 s stays far above
#                                the float32 rounding floor of the irfft
KERNEL_TOL = 1e-4  # kernel level: max abs error / max |reference|
# systems a block of csrc/cinv.cu's kernels at the N the tests take: one a
# thread in a tile at N <= 8, floor(32 / N) a warp at N > 8 (4 warps a block
# to N = 16, 2 above); test_torch_kernel_sources.py holds it to the source
CINV_BLOCK_SYSTEMS = {1: 128, 4: 128, 8: 32, 9: 12, 12: 8, 27: 2}
# and of csrc/lu.cu's solve: a tile at N <= 8, floor(32 / N) a warp at N > 8
# (8 warps a block to N = 24, 4 above)
LU_BLOCK_SYSTEMS = {1: 128, 4: 128, 8: 32, 9: 24, 12: 16, 27: 4}
# and of its transposed solve (B6): one thread a system, 128 a block to
# N = 12 (w in registers), 64 above (w in shared memory)
LUT_BLOCK_SYSTEMS = {1: 128, 4: 128, 9: 128, 12: 128, 27: 64}


def systems(k: int, n: int, seed: int):
    """K random complex64 N x N systems (a third with a zero leading pivot,
    so elimination must pivot) and right-hand sides."""
    rng = np.random.RandomState(seed)
    m = (2.0 * np.eye(n)[None] + 0.4 * rng.randn(k, n, n)
         + 0.4j * rng.randn(k, n, n)).astype(np.complex64)
    m[: k // 3, 0, 0] = 0.0
    b = (rng.randn(k, n) + 1j * rng.randn(k, n)).astype(np.complex64)
    return m, b


def cinv_systems(k: int, n: int, seed: int):
    """The matrices of :func:`systems`, with the 1 x 1 ones kept off zero
    (a 1 x 1 system has no row to pivot to)."""
    m, _ = systems(k, n, seed=seed)
    if n == 1:
        m[:, 0, 0] += 1.0
    return m


def cascade(r: int, k: int, f: int, seed: int):
    """R random K-section biquad cascades (poles inside the unit circle) and
    F points z on the upper unit half circle."""
    rng = np.random.RandomState(seed)
    num = rng.randn(r, k, 3).astype(np.float32)
    den = rng.randn(r, k, 3).astype(np.float32)
    den[..., 0] += 4.0
    z = np.exp(1j * np.linspace(0.0, np.pi, f)).astype(np.complex64)
    return num, den, z


def max_rel(a, ref) -> float:
    """max |a - ref| / max |ref|."""
    return float(np.abs(np.asarray(a) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def raw_config(tmp_path, svf: bool, zero_coupling: bool = True, nfft: int = 4096,
               batch: int = 4) -> dict:
    """A narrow DiffGFDNVarReceiverPos config: SVF heads + GEQ filters, or
    scalar heads + scalar absorption."""
    return dict(
        seed=7, num_groups=3, sample_rate=FS, num_delay_lines=12,
        delay_range_ms=[20.0, 45.0],
        trainer_config=dict(
            batch_size=batch, num_freq_bins=nfft, max_epochs=1,
            train_dir=str(tmp_path / f"train_svf{svf}_zc{zero_coupling}"),
        ),
        output_filter_config=dict(
            use_svfs=svf, num_hidden_layers=2, num_neurons_per_layer=16,
            num_fourier_features=4,
        ),
        feedback_loop_config=dict(use_zero_coupling=zero_coupling),
        decay_filter_config=dict(use_absorption_filters=svf),
        colorless_fdn_config=dict(use_colorless_prototype=False),
    )


def rooms(tmp_path, svf: bool, nfft: int):
    """(JAX dataset, port dataset) parsed from one synthetic pickle."""
    from diffgfdn_torch.data import ThreeRoomDataset
    from diffgfdn_tpu.data import generate_three_room_pickle
    from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset

    path = generate_three_room_pickle(
        tmp_path / "srirs.pkl", fs=FS, num_rec_per_room=3, rir_len_s=0.5,
        decay_times=DECAY_TIMES,
    )
    jax_room = JaxThreeRoomDataset(path, nfft=nfft)
    port_room = ThreeRoomDataset(path, nfft=nfft)
    if svf:  # per-band decay times (num_bands, num_groups) select the GEQ fit
        cdt = np.stack([np.array(DECAY_TIMES)] * len(BANDS)) * np.linspace(
            1.2, 0.8, len(BANDS)
        )[:, None]
        for room in (jax_room, port_room):
            room.common_decay_times = cdt
            room.band_centre_hz = BANDS
    return jax_room, port_room


def jax_model_and_params(cfg, room, batch: int, inference_solve: bool = False):
    """JAX DiffGFDNVarReceiverPos (XLA path on CPU) and its initial params."""
    import jax

    from diffgfdn_tpu.data.batching import arrays_from_room_dataset, init_example_batch
    from diffgfdn_tpu.training.build import build_gfdn_model
    from diffgfdn_tpu.utils.cio import init_with_batch

    model = build_gfdn_model(
        cfg, common_decay_times=room.common_decay_times,
        band_centre_hz=room.band_centre_hz, inference_solve=inference_solve,
        use_pallas_inverse=False,
    )
    arrays = arrays_from_room_dataset(room)
    params = init_with_batch(model, jax.random.PRNGKey(3), init_example_batch(arrays, batch))
    return model, params


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def edc_db(x: np.ndarray) -> np.ndarray:
    e = np.cumsum((np.asarray(x, np.float64) ** 2)[..., ::-1], axis=-1)[..., ::-1]
    return 10.0 * np.log10(e + 1e-300)


# subband tests: three octave bands in two architecture groups (500 and 1000 Hz
# share a 1 x 16 MLP, 2000 Hz has 2 x 16), scalar heads, GEQ absorption and
# the colorless loss as the subband presets set them
SUBBAND_FREQS = (500.0, 1000.0, 2000.0)
SUBBAND_MLP = {500.0: (1, 16), 1000.0: (1, 16), 2000.0: (2, 16)}
SUBBAND_NFFT = 2 ** 12


def subband_room_path(tmp_path):
    """A synthetic 24-receiver dataset at 8 kHz with the long decays above."""
    from diffgfdn_tpu.data import generate_three_room_pickle

    return generate_three_room_pickle(tmp_path / "srirs.pkl", fs=FS, num_rec_per_room=8,
                                      rir_len_s=0.5, decay_times=DECAY_TIMES)


def subband_rooms(path, nfft: int = SUBBAND_NFFT):
    """(JAX dataset, port dataset) with per-band decay times (GEQ absorption)."""
    from diffgfdn_torch.data import ThreeRoomDataset
    from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset

    cdt = np.stack([np.array(DECAY_TIMES)] * len(BANDS)) * np.linspace(
        1.2, 0.8, len(BANDS))[:, None]
    out = (JaxThreeRoomDataset(path, nfft=nfft), ThreeRoomDataset(path, nfft=nfft))
    for room in out:
        room.common_decay_times = cdt
        room.band_centre_hz = BANDS
    return out


def subband_configs(monkeypatch, path, train_dir, nfft: int = SUBBAND_NFFT,
                    freqs=SUBBAND_FREQS, spectral_weight=None, **kw):
    """(JAX configs, port configs) of the bands from each package's
    ``create_config``, with the narrow MLPs above; ``spectral_weight`` replaces
    the colorless spectral term's weight."""
    from diffgfdn_torch.cli import run_subband_training as port_cli
    from diffgfdn_tpu.cli import run_subband_training as jax_cli

    out = []
    for cli in (jax_cli, port_cli):
        monkeypatch.setattr(cli, "BAND_MLP_PARAMS", dict(SUBBAND_MLP))
        cfgs = [cli.create_config(f, str(path), str(train_dir), nfft, sample_rate=FS,
                                  batch_size=8, **kw) for f in freqs]
        if spectral_weight is not None:
            for cfg in cfgs:
                cfg.trainer_config.spectral_loss_weight = spectral_weight
        out.append(cfgs)
    return out


# directional tests: the synthetic spatial dataset (the 12 t-design directions,
# 9 SH channels) on a coarse grid, models at fs 8 kHz
SPATIAL_GRID_M = 1.2  # 44 receivers


def directional_raw_config(tmp_path, ambi_order: int, nfft: int = 1024, batch: int = 4,
                           **trainer) -> dict:
    """A narrow DiffDirectionalFDNVarReceiverPos config: skip-connection MLP
    (2 x 16, 4 Fourier features), max-directivity beamformer, scalar
    absorption, the colorless loss on; ``trainer`` updates the trainer config."""
    return dict(
        seed=11, num_groups=3, sample_rate=FS, ambi_order=ambi_order,
        delay_range_ms=[20.0, 45.0],
        trainer_config={
            **dict(batch_size=batch, num_freq_bins=nfft, max_epochs=1, use_colorless_loss=True,
                   use_asym_spectral_loss=True, edc_loss_weight=10.0, sparsity_loss_weight=2.0,
                   train_dir=str(tmp_path / f"train_dir{ambi_order}")),
            **trainer,
        },
        output_filter_config=dict(
            use_svfs=False, num_hidden_layers=2, num_neurons_per_layer=16,
            num_fourier_features=4, use_skip_connections=True,
            beamformer_type="max_directivity",
        ),
        decay_filter_config=dict(use_absorption_filters=False),
        colorless_fdn_config=dict(use_colorless_prototype=False),
    )


def spatial_rooms(tmp_path, fs: float = FS, decay_times=DECAY_TIMES, rir_len_s: float = 0.25):
    """(JAX dataset, port dataset) parsed from one synthetic spatial pickle."""
    from diffgfdn_torch.data import SpatialThreeRoomDataset
    from diffgfdn_tpu.data.spatial_dataset import generate_spatial_three_room_pickle
    from diffgfdn_tpu.data.spatial_dataset import (
        SpatialThreeRoomDataset as JaxSpatialThreeRoomDataset,
    )

    path = generate_spatial_three_room_pickle(
        tmp_path / "spatial.pkl", fs=fs, grid_spacing_m=SPATIAL_GRID_M, rir_len_s=rir_len_s,
        decay_times=decay_times,
    )
    return JaxSpatialThreeRoomDataset(path), SpatialThreeRoomDataset(path)


def jax_directional_model_and_params(cfg, room, batch: int, inference_solve: bool = False):
    """JAX DiffDirectionalFDNVarReceiverPos (XLA path on CPU), built as its
    solver builds it, and its initial params."""
    import jax

    from diffgfdn_tpu.data.batching import init_example_batch
    from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset
    from diffgfdn_tpu.training.build import build_gfdn_model
    from diffgfdn_tpu.utils.cio import init_with_batch

    model = build_gfdn_model(
        cfg, common_decay_times=room.common_decay_times, band_centre_hz=room.band_centre_hz,
        desired_directions=room.desired_directions, variant="directional",
        inference_solve=inference_solve, use_pallas_inverse=False,
    )
    arrays = arrays_from_spatial_dataset(room)
    params = init_with_batch(model, jax.random.PRNGKey(3), init_example_batch(arrays, batch))
    return model, params


# common-slopes spatial-sampling tests: the JAX package's own fixture
# (tests/test_spatial_training.py): a 0.6 m grid at fs 8 kHz, 0.2 s SRIRs,
# decays 0.05 / 0.09 / 0.07 s; batch 16, a 1 x 32 MLP, 4 Fourier features
CS_GRID_M = 0.6
CS_RESOLUTION_M = 1.2  # the split the JAX tests train at: 52 train, 140 valid


def cs_room_path(tmp_path):
    """The synthetic spatial pickle of JAX's spatial-training fixture."""
    from diffgfdn_tpu.data.spatial_dataset import generate_spatial_three_room_pickle

    return generate_spatial_three_room_pickle(
        tmp_path / "cs_srirs.pkl", grid_spacing_m=CS_GRID_M, rir_len_s=0.2,
        decay_times=(0.05, 0.09, 0.07),
    )


def cs_rooms(path):
    """(JAX dataset, port dataset) parsed from one spatial pickle."""
    from diffgfdn_torch.data import SpatialThreeRoomDataset
    from diffgfdn_tpu.data.spatial_dataset import (
        SpatialThreeRoomDataset as JaxSpatialThreeRoomDataset,
    )

    return JaxSpatialThreeRoomDataset(path), SpatialThreeRoomDataset(path)


def cs_raw_config(train_dir, directional: bool, epochs: int = 4) -> dict:
    """JAX's spatial-training test config as a mapping for both schemas."""
    return dict(
        batch_size=16, seed=0, max_epochs=epochs, lr=5e-3, train_dir=str(train_dir),
        use_directional_rirs=directional,
        dnn_config=dict(mlp_config=dict(num_neurons_per_layer=32, num_hidden_layers=1),
                        num_fourier_features=4),
    )


def cs_configs(raw: dict):
    """(JAX config, port config) of one raw mapping."""
    from diffgfdn_torch.config import SpatialSamplingConfig
    from diffgfdn_tpu.config.schema import SpatialSamplingConfig as JaxSpatialSamplingConfig

    return JaxSpatialSamplingConfig.model_validate(raw), SpatialSamplingConfig.from_dict(raw)


def cs_models(jcfg, cfg, jax_room, num_init: int = 16):
    """(JAX model, its params from PRNGKey(seed) as run_training_spatial_sampling
    draws them, the port model on the CPU with those params loaded)."""
    import jax

    from diffgfdn_torch.training import build_spatial_model
    from diffgfdn_torch.utils.params import load_jax_params
    from diffgfdn_tpu.training.spatial_trainer import build_spatial_model as jax_build

    jmodel = jax_build(jcfg, jax_room.num_rooms, jax_room.ambi_order)
    example = {"norm_listener_position":
               jax_room.norm_receiver_position[:num_init].astype(np.float32)}
    params = jmodel.init(jax.random.PRNGKey(jcfg.seed), example)
    model = build_spatial_model(cfg, jax_room.num_rooms, jax_room.ambi_order, device="cpu")
    load_jax_params(model, params)
    return jmodel, params, model


# single-position tests: a two-slope synthetic RIR written as a wav at 8 kHz,
# fit at nfft 2^12 with a 0.5 s broadband decay time per group, as
# run_training_single_pos reads it
SINGLE_POS_NFFT = 2 ** 12
SINGLE_POS_WAV = "ir_(1.20, 3.40, 0.90).wav"


def write_two_slope_wav(directory, fs: float = FS, seconds: float = 0.45, seed: int = 3,
                        name: str = SINGLE_POS_WAV, dtype=np.float32):
    """A direct impulse and noise under two exponential decays (T60 0.15 and
    0.6 s), peak 0.9, written as ``directory / name``; returns the path."""
    from diffgfdn_tpu.data.audio import write_wav

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * fs)) / fs
    rir = rng.randn(t.size) * (np.exp(-6.9 * t / 0.15) + 0.2 * np.exp(-6.9 * t / 0.6))
    rir[0] = 4.0
    rir = 0.9 * rir / np.abs(rir).max()
    path = directory / name
    if dtype == np.int16:
        from scipy.io import wavfile

        wavfile.write(str(path), int(fs), (rir * 32767).astype(np.int16))
    else:
        write_wav(path, rir.astype(np.float32), fs)
    return path


def single_pos_raw(tmp_path, svf_out: bool, svf_in: bool, num_groups: int = 3,
                   num_delay_lines: int = 12, epochs: int = 3, **trainer) -> dict:
    """A single-position config: per-group SVF or scalar heads on each side,
    scalar absorption, nfft 2^12 at 8 kHz; ``trainer`` updates the trainer config."""
    return dict(
        seed=5, num_groups=num_groups, sample_rate=FS, num_delay_lines=num_delay_lines,
        delay_range_ms=[20.0, 45.0], ir_path=str(tmp_path / SINGLE_POS_WAV),
        trainer_config={
            **dict(batch_size=1, num_freq_bins=SINGLE_POS_NFFT, max_epochs=epochs, lr=1e-2,
                   io_lr=0.05, train_dir=str(tmp_path / f"sp_out{svf_out}_in{svf_in}"),
                   ir_dir=str(tmp_path / "audio")),
            **trainer,
        },
        output_filter_config=dict(use_svfs=svf_out),
        input_filter_config=dict(use_svfs=svf_in) if svf_in else None,
        decay_filter_config=dict(use_absorption_filters=False),
        colorless_fdn_config=dict(use_colorless_prototype=False),
    )


def single_pos_batch(jcfg, rir):
    """The full-spectrum batch JAX's run_training_single_pos builds (numpy)."""
    from diffgfdn_tpu.training.solver import parse_position_from_filename

    z = np.exp(1j * rir.freq_bins_rad).astype(np.complex64)
    early, late = rir.split_responses()
    return {
        "z_values": z,
        "listener_position": parse_position_from_filename(jcfg.ir_path)[None, :],
        "norm_listener_position": np.zeros((1, 3), np.float32),
        "target_early_response": early.astype(np.complex64),
        "target_late_response": late.astype(np.complex64),
        "target_rir_response": rir.rir_mag_response.astype(np.complex64),
    }


def single_pos_models(raw, tmp_path, colorless_params=None):
    """(JAX config, JAX model, its initial params, port model with them
    loaded, the numpy batch, the port's RIRData) of a single-position config,
    the wav written first."""
    import jax

    from diffgfdn_torch.config.schema import DiffGFDNConfig
    from diffgfdn_torch.data import RIRData
    from diffgfdn_torch.training import build_gfdn_model
    from diffgfdn_torch.utils.params import load_jax_params
    from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
    from diffgfdn_tpu.data.room_dataset import RIRData as JaxRIRData
    from diffgfdn_tpu.training.build import build_gfdn_model as jax_build
    from diffgfdn_tpu.utils.cio import init_with_batch

    path = write_two_slope_wav(tmp_path)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    cdt = np.array([0.5] * jcfg.num_groups)
    jrir = JaxRIRData.from_wav(path, common_decay_times=cdt, nfft=SINGLE_POS_NFFT)
    rir = RIRData.from_wav(path, common_decay_times=cdt, nfft=SINGLE_POS_NFFT)
    jmodel = jax_build(jcfg, common_decay_times=cdt, colorless_params=colorless_params,
                       variant="single_pos", use_pallas_inverse=False)
    batch = single_pos_batch(jcfg, jrir)
    params = init_with_batch(jmodel, jax.random.PRNGKey(jcfg.seed), batch)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, cdt, variant="single_pos", device="cpu",
                             colorless_params=colorless_params)
    load_jax_params(model, params)
    return jcfg, jmodel, params, model, batch, rir
