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


def systems(k: int, n: int, seed: int):
    """K random complex64 N x N systems (a third with a zero leading pivot,
    so elimination must pivot) and right-hand sides."""
    rng = np.random.RandomState(seed)
    m = (2.0 * np.eye(n)[None] + 0.4 * rng.randn(k, n, n)
         + 0.4j * rng.randn(k, n, n)).astype(np.complex64)
    m[: k // 3, 0, 0] = 0.0
    b = (rng.randn(k, n) + 1j * rng.randn(k, n)).astype(np.complex64)
    return m, b


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
