"""The port's ``utils/plot.py`` against the JAX package.

Every plotting function writes its file (Agg) on the inputs of JAX's
``tests/test_plot_and_misc.py``; the data helpers, ``plot_edr``'s EDR
(float32 STFTs: 1e-4 dB) and the beamformer map's dB limits (float64:
1e-10) equal JAX's. What the module unblocks (the feedback-matrix
animation, the trainer's beamformer maps) is in test_torch_plot_paths.py.
"""

import numpy as np

from diffgfdn_torch.utils import plot as dplot
from diffgfdn_tpu.data import THREE_ROOM_APERTURES, THREE_ROOM_DIMS, THREE_ROOM_START
from diffgfdn_tpu.utils import plot as jax_plot

EDR_TOL_DB = 1e-4
HOST_TOL = 1e-10


def test_plot_smoke(tmp_path):
    rng = np.random.RandomState(0)
    dplot.plot_loss_curves([3.0, 2.0, 1.5], [3.2, 2.4, 1.9],
                           individual=[{"edc": 2.0, "edr": 1.0}] * 3,
                           save_path=str(tmp_path / "loss.png"))
    rirs = rng.randn(2, 2000) * np.exp(-np.arange(2000) / 300)[None]
    dplot.plot_edc_comparison(rirs, ["true", "approx"], 8000.0, save_path=str(tmp_path / "edc.png"))
    dplot.plot_magnitude_response(np.abs(rng.randn(2, 257)) + 0.1, np.linspace(20, 4000, 257),
                                  ["a", "b"], save_path=str(tmp_path / "mag.png"))
    dplot.plot_spectrogram(rirs[0], 8000.0, save_path=str(tmp_path / "spec.png"))
    pos = rng.rand(30, 2) * np.array([10, 8])
    dplot.plot_position_map(pos, rng.rand(30), THREE_ROOM_DIMS, THREE_ROOM_START,
                            THREE_ROOM_APERTURES, title="amps", save_path=str(tmp_path / "map.png"))
    dplot.plot_edr_error_map(pos, rng.rand(30), THREE_ROOM_DIMS, THREE_ROOM_START,
                             save_path=str(tmp_path / "edr_map.png"))
    dplot.plot_matrix(rng.randn(6, 6), save_path=str(tmp_path / "mat.png"))
    for name in ("loss", "edc", "mag", "spec", "map", "edr_map", "mat"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name


def test_plot_t60_filter_response(tmp_path):
    from diffgfdn_torch.ops.absorption import decay_times_to_gain_filters_geq

    bands = np.array([125.0, 250, 500, 1000, 2000])
    coeffs = decay_times_to_gain_filters_geq(bands, np.linspace(0.8, 0.3, 5), [499, 601], 8000.0)
    target = (10 ** (-3 / 8000.0 / np.linspace(0.8, 0.3, 5))) ** 499
    dplot.plot_t60_filter_response(bands, target[None], coeffs[..., 0].transpose(1, 0, 2),
                                   coeffs[..., 1].transpose(1, 0, 2), 8000.0,
                                   save_path=str(tmp_path / "t60.png"))
    assert (tmp_path / "t60.png").exists()


def test_data_helpers_equal_jax_s(tmp_path):
    rng = np.random.RandomState(5)
    pos, vals = rng.rand(17, 3), rng.rand(17)
    pos[3, :2] = pos[9, :2]  # a tie the stable sort keeps in order
    for got, want in zip(dplot.order_position_matrices(pos, vals),
                         jax_plot.order_position_matrices(pos, vals)):
        assert np.array_equal(got, want)
    poly = rng.randn(6, 2, 2)
    for got, want in zip(dplot.polynomial_matrix_response(poly, 128),
                         jax_plot.polynomial_matrix_response(poly, 128)):
        assert np.array_equal(got, want)
    dplot.plot_polynomial_matrix_ir(poly, 8000.0, save_path=str(tmp_path / "poly_ir.png"))
    dplot.plot_polynomial_matrix_ir(poly, 8000.0, plot_db=True, rt60=0.5, title="taps",
                                    save_path=str(tmp_path / "poly_ir_db.png"))
    dplot.plot_polynomial_matrix_magnitude(poly, 8000.0, 128, title="mag",
                                           save_path=str(tmp_path / "poly_mag.png"))
    for name in ("poly_ir", "poly_ir_db", "poly_mag"):
        assert (tmp_path / f"{name}.png").exists()


def test_animate_coupled_feedback_matrix(tmp_path):
    rng = np.random.RandomState(0)
    mats = [rng.randn(6, 6) for _ in range(3)]
    coup = [rng.rand(2, 2) for _ in range(3)]
    dplot.animate_coupled_feedback_matrix(mats, coup, save_path=str(tmp_path / "anim.gif"))
    dplot.animate_coupled_feedback_matrix(mats, save_path=str(tmp_path / "anim1.gif"))
    assert (tmp_path / "anim.gif").stat().st_size > 0 and (tmp_path / "anim1.gif").exists()


def test_subband_edc_and_amplitude_figures(tmp_path):
    fs = 8000.0
    t = np.arange(int(0.3 * fs)) / fs
    true_rir = np.random.RandomState(0).randn(len(t)) * np.exp(-t * 20.0)
    approx = [true_rir * 0.8, true_rir * 0.95]
    bands = [500.0, 1000.0, 2000.0]
    dplot.plot_subband_edc(true_rir, approx, fs, bands, pos_to_investigate=(1.0, 2.0, 1.5),
                           save_path=str(tmp_path / "sub_edc.png"))
    cdt = np.tile(np.array([[0.1, 0.15]]), (3, 1))  # (bands, groups)
    dplot.plot_subband_amplitudes(true_rir, approx[0], fs, 2, np.full((3, 1, 2), 0.5), cdt, bands,
                                  save_path=str(tmp_path / "sub_amps.png"))
    assert (tmp_path / "sub_edc.png").exists() and (tmp_path / "sub_amps.png").exists()


def test_beamformer_map_limits_equal_jax_s(tmp_path, record_property):
    from diffgfdn_torch.ops.sph import t_design_directions

    tdes = t_design_directions(5)
    dirs = np.stack([tdes[0], np.pi / 2 - tdes[1]])  # (azimuth, elevation)
    amps = np.random.RandomState(0).rand(dirs.shape[1], 3)
    limits = dplot.plot_beamformer_map(amps, dirs, ambi_order=2, num_groups=3,
                                       save_path=str(tmp_path / "beam.png"))
    want = jax_plot.plot_beamformer_map(amps, dirs, ambi_order=2, num_groups=3)
    err = float(np.abs(limits - want).max())
    record_property("limits_max_abs_db", err)
    assert limits.shape == (2, 3) and err <= HOST_TOL
    again = dplot.plot_beamformer_map(amps * 0.5, dirs, ambi_order=2, num_groups=3,
                                      save_path=str(tmp_path / "beam2.png"), db_limits=limits)
    assert again is limits and (tmp_path / "beam2.png").exists()


def test_animate_moving_listener(tmp_path):
    path = np.stack([np.linspace(0.5, 3.5, 8), np.full(8, 2.0)], axis=-1)
    out = tmp_path / "walk.mp4"
    dplot.animate_moving_listener(path, room_dims=[(4.0, 8.0, 3.0), (6.0, 3.0, 3.0)],
                                  room_start_coords=[(0.0, 0.0, 0.0), (4.0, 2.0, 0.0)],
                                  yaw_angles=np.linspace(0, np.pi / 2, 8),
                                  source_position=np.array([1.0, 1.0, 1.5]), save_path=str(out))
    assert out.exists() or out.with_suffix(".gif").exists()


def test_plot_edr_matches_jax_and_learned_svf_response(tmp_path, record_property):
    import torch

    from diffgfdn_torch.ops.biquad import peak_filter_np

    rir = np.random.RandomState(1).randn(4000) * np.exp(-np.arange(4000) / 400)
    edr = dplot.plot_edr(rir, 8000.0, win_size=256, hop_size=128, log_freq_axis=True,
                         title="EDR", save_path=str(tmp_path / "edr.png"))
    want = jax_plot.plot_edr(rir, 8000.0, win_size=256, hop_size=128)
    err = float(np.abs(edr - want).max())
    record_property("edr_max_abs_db", err)
    assert edr.shape == want.shape and err <= EDR_TOL_DB
    assert (tmp_path / "edr.png").exists() and np.all(np.diff(edr, axis=-1) <= 1e-6)
    from_tensor = dplot.plot_edr(torch.as_tensor(rir, dtype=torch.float32), 8000.0,
                                 win_size=256, hop_size=128)
    assert np.array_equal(from_tensor, edr)

    def cascade(gain_db):
        return np.stack([np.concatenate(peak_filter_np(f0, 10.0 ** (gain_db / 20.0), 0.7, 8000.0))
                         for f0 in (200.0, 800.0, 2500.0)])

    per_epoch = [np.stack([cascade(3.0), cascade(-2.0)]), np.stack([cascade(1.0), cascade(-4.0)])]
    dplot.plot_learned_svf_response(per_epoch, 8000.0, pos_to_investigate=[1.0, 2.0, 1.5],
                                    epoch_numbers=[-1, 0], save_path=str(tmp_path / "svf.png"))
    assert (tmp_path / "svf_output_filter_response.png").exists()
    assert (tmp_path / "svf_output_filter_pz_plot.png").exists()
