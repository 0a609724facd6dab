"""Plot diagnostics (matplotlib, host side; port of ``utils/plot.py``).

Loss curves, EDC / EDR comparisons, magnitude responses, absorption-filter
fits, spectrograms, floor-plan maps of per-position values, matrix heat
maps, polynomial-matrix responses, the coupled-matrix and moving-listener
animations, the per-band EDC and amplitude figures, SH-interpolated
beamformer maps and learned SVF responses.

matplotlib is imported (with the Agg backend) when a plotting function is
called, never when this module is imported: the card's image may lack it,
and every other module of the port imports without it. The data helpers
(:func:`order_position_matrices`, :func:`polynomial_matrix_response`) need
no matplotlib. :func:`plot_edr` computes its EDR with ``ops/stft.py`` on the
device of a tensor argument (the CPU for a numpy one).
"""

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.basic import db_np


def pyplot():
    """matplotlib.pyplot on the Agg backend, imported on first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_or_show(fig, save_path: Optional[str] = None):
    """Save the figure at ``save_path`` (parents made) and close it; return it."""
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight", dpi=150)
        pyplot().close(fig)
    return fig


def plot_loss_curves(
    train_loss: Sequence[float],
    valid_loss: Optional[Sequence[float]] = None,
    individual: Optional[List[dict]] = None,
    save_path: Optional[str] = None,
):
    """Total training (and validation) loss per epoch, and each term dashed."""
    fig, ax = pyplot().subplots(figsize=(7, 4))
    ax.plot(train_loss, label="train")
    if valid_loss is not None and len(valid_loss):
        ax.plot(valid_loss, label="valid")
    if individual:
        for k in individual[0].keys():
            ax.plot([d[k] for d in individual], "--", alpha=0.6, label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(alpha=0.3)
    return save_or_show(fig, save_path)


def plot_edc_comparison(
    rirs: np.ndarray,
    labels: Sequence[str],
    fs: float,
    save_path: Optional[str] = None,
):
    """Schroeder EDCs of several RIRs in dB, each normalized to its start."""
    fig, ax = pyplot().subplots(figsize=(7, 4))
    for rir, label in zip(rirs, labels):
        edc = np.flip(np.cumsum(np.flip(np.asarray(rir) ** 2)))
        edc = edc / (edc[0] + 1e-12)
        t = np.arange(len(edc)) / fs
        ax.plot(t, 10 * np.log10(edc + 1e-12), label=label)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("EDC [dB]")
    ax.set_ylim(-80, 5)
    ax.legend()
    ax.grid(alpha=0.3)
    return save_or_show(fig, save_path)


def plot_magnitude_response(
    responses: np.ndarray,
    freqs_hz: np.ndarray,
    labels: Sequence[str],
    save_path: Optional[str] = None,
):
    """Magnitude responses in dB on a log-frequency axis."""
    fig, ax = pyplot().subplots(figsize=(7, 4))
    for resp, label in zip(np.atleast_2d(responses), labels):
        ax.semilogx(freqs_hz, db_np(resp), label=label, alpha=0.8)
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("magnitude [dB]")
    ax.legend()
    ax.grid(alpha=0.3, which="both")
    return save_or_show(fig, save_path)


def plot_t60_filter_response(
    band_centre_hz: np.ndarray,
    target_gains: np.ndarray,
    num_coeffs: np.ndarray,
    den_coeffs: np.ndarray,
    fs: float,
    save_path: Optional[str] = None,
):
    """Absorption-filter responses of up to 8 lines against their per-band
    target gains (o). ``num_coeffs`` / ``den_coeffs``: (n_sections, n_lines,
    3), or (n_sections, 3) for one filter."""
    from ..ops.biquad import sos_response_np

    freqs = np.geomspace(20.0, fs / 2 * 0.95, 512)
    fig, ax = pyplot().subplots(figsize=(7, 4))
    num_lines = num_coeffs.shape[1] if num_coeffs.ndim == 3 else 1
    targets = np.atleast_2d(target_gains)
    for i in range(min(num_lines, 8)):
        if num_coeffs.ndim == 3:
            sos = np.concatenate([num_coeffs[:, i, :], den_coeffs[:, i, :]], axis=-1)
        else:
            sos = np.concatenate([num_coeffs, den_coeffs], axis=-1)
        resp = sos_response_np(sos, freqs, fs)
        ax.semilogx(freqs, db_np(resp), alpha=0.7, label=f"line {i}")
        ax.semilogx(band_centre_hz, db_np(targets[min(i, targets.shape[0] - 1)]), "o")
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("gain [dB]")
    ax.set_title("absorption filter fits")
    ax.grid(alpha=0.3, which="both")
    return save_or_show(fig, save_path)


def plot_spectrogram(rir: np.ndarray, fs: float, win: int = 512,
                     save_path: Optional[str] = None):
    """Log-magnitude spectrogram of an RIR (scipy's STFT)."""
    from scipy.signal import stft as scipy_stft

    f, t, s = scipy_stft(rir, fs=fs, nperseg=win)
    fig, ax = pyplot().subplots(figsize=(7, 4))
    im = ax.pcolormesh(t, f, 20 * np.log10(np.abs(s) + 1e-9), shading="auto", cmap="magma")
    fig.colorbar(im, ax=ax, label="dB")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [Hz]")
    return save_or_show(fig, save_path)


def draw_room_boundaries(ax, room_dims: List, room_start_coord: List,
                         aperture_coords: Optional[List] = None):
    """Draw the coupled rooms' floor plan (rectangles, apertures dashed)."""
    plt = pyplot()
    for dims, start in zip(room_dims, room_start_coord):
        ax.add_patch(plt.Rectangle((start[0], start[1]), dims[0], dims[1],
                                   fill=False, edgecolor="k", linewidth=1.5))
    if aperture_coords:
        for (x0, y0), (x1, y1) in aperture_coords:
            ax.plot([x0, x1], [y0, y1], "w-", linewidth=3)
            ax.plot([x0, x1], [y0, y1], "g--", linewidth=1.5)
    ax.set_aspect("equal")
    return ax


def plot_position_map(
    positions: np.ndarray,
    values: np.ndarray,
    room_dims: List,
    room_start_coord: List,
    aperture_coords: Optional[List] = None,
    title: str = "",
    cbar_label: str = "",
    save_path: Optional[str] = None,
):
    """Scatter a per-position quantity (amplitudes, EDC errors) over the floor plan."""
    fig, ax = pyplot().subplots(figsize=(7, 6))
    draw_room_boundaries(ax, room_dims, room_start_coord, aperture_coords)
    sc = ax.scatter(positions[:, 0], positions[:, 1], c=values, cmap="viridis", s=35)
    fig.colorbar(sc, ax=ax, label=cbar_label)
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return save_or_show(fig, save_path)


def plot_matrix(matrix: np.ndarray, title: str = "", save_path: Optional[str] = None):
    """Heat map of a (coupled feedback) matrix."""
    fig, ax = pyplot().subplots(figsize=(5, 4))
    im = ax.imshow(np.asarray(matrix), cmap="RdBu_r")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    return save_or_show(fig, save_path)


def order_position_matrices(positions: np.ndarray, values: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Positions and a parallel value array sorted in raster order: a stable
    lexicographic sort by (y, x)."""
    order = np.lexsort((positions[:, 0], positions[:, 1]))
    return positions[order], values[order]


def plot_edr_error_map(positions: np.ndarray, edr_errors_db: np.ndarray, room_dims: List,
                       room_start_coord: List, save_path: Optional[str] = None):
    """Mean EDR error per receiver over the floor plan."""
    return plot_position_map(positions, edr_errors_db, room_dims, room_start_coord,
                             title="mean EDR error", cbar_label="dB", save_path=save_path)


# polynomial (FIR-paraunitary) matrices: (order, N, N), the leading axis the
# power of z^-1, as the FILTER-coupled feedback loop holds them


def polynomial_matrix_response(poly: np.ndarray, num_bins: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Response of a polynomial matrix (order, N, N) on the upper half unit
    circle: ((num_bins, N, N) complex, normalized frequencies in [0, 1))."""
    poly = np.asarray(poly)
    order = poly.shape[0]
    w = np.arange(num_bins) / num_bins
    zinv_pow = np.exp(-1j * np.pi * w[:, None] * np.arange(order)[None, :])
    return np.einsum("fo,onm->fnm", zinv_pow, poly.astype(complex)), w


def plot_polynomial_matrix_ir(
    poly: np.ndarray,
    fs: float,
    plot_db: bool = False,
    rt60: Optional[float] = None,
    title: Optional[str] = None,
    save_path: Optional[str] = None,
):
    """N x N grid of the polynomial matrix's entry impulse responses."""
    poly = np.asarray(poly)
    order, n, _ = poly.shape
    t = np.arange(order) / fs
    fig, ax = pyplot().subplots(n, n, figsize=(8, 5), sharex=True, squeeze=False)
    for i in range(n):
        for j in range(n):
            y = db_np(np.abs(poly[:, i, j]) + 1e-12) if plot_db else poly[:, i, j]
            ax[i, j].plot(t, y, linewidth=0.8)
            if rt60 is not None:
                ax[i, j].set_xlim(0.0, rt60 + 0.1)
    ax[-1, 0].set_xlabel("Time (s)")
    ax[0, 0].set_ylabel("Amplitude (dB)" if plot_db else "Amplitude")
    if title:
        fig.suptitle(title)
    return save_or_show(fig, save_path)


def plot_polynomial_matrix_magnitude(
    poly: np.ndarray,
    fs: float,
    num_bins: int = 512,
    title: Optional[str] = None,
    save_path: Optional[str] = None,
):
    """N x N grid of the polynomial matrix's entry magnitude responses."""
    resp, w = polynomial_matrix_response(poly, num_bins)
    n = resp.shape[-1]
    freq_hz = 0.5 * fs * w
    fig, ax = pyplot().subplots(n, n, figsize=(8, 5), sharex=True, sharey=True, squeeze=False)
    for i in range(n):
        for j in range(n):
            ax[i, j].semilogx(freq_hz[1:], db_np(np.abs(resp[1:, i, j]) + 1e-12),
                              linewidth=0.8)
    ax[-1, 0].set_xlabel("Frequency (Hz)")
    ax[0, 0].set_ylabel("Magnitude (dB)")
    if title:
        fig.suptitle(title)
    return save_or_show(fig, save_path)


def animate_coupled_feedback_matrix(
    feedback_matrices: Sequence[np.ndarray],
    coupling_matrices: Optional[Sequence[np.ndarray]] = None,
    save_path: Optional[str] = None,
    fps: int = 2,
):
    """Animate |A| (and the room-coupling matrix, when given) over epochs;
    saved as a GIF with the pillow writer."""
    from matplotlib import animation

    plt = pyplot()
    with_coupling = coupling_matrices is not None
    if with_coupling:
        fig, axes = plt.subplots(2, 1, figsize=(6, 8))
        ims = [
            axes[0].matshow(np.abs(feedback_matrices[0]), cmap="viridis"),
            axes[1].matshow(np.asarray(coupling_matrices[0]), cmap="viridis",
                            vmin=0.0, vmax=1.0),
        ]
        axes[0].set_title("Coupled feedback matrix")
        axes[1].set_title("Coupling matrix")
        for im, a in zip(ims, axes):
            fig.colorbar(im, ax=a)
    else:
        fig, ax = plt.subplots()
        ims = [ax.matshow(np.abs(feedback_matrices[0]), cmap="viridis")]
        ax.set_title("Coupled feedback matrix")
        fig.colorbar(ims[0], ax=ax)

    def update(frame):
        ims[0].set_array(np.abs(feedback_matrices[frame]))
        if with_coupling:
            ims[1].set_array(np.asarray(coupling_matrices[frame]))
        return ims

    ani = animation.FuncAnimation(fig, update, frames=len(feedback_matrices),
                                  interval=1000 // fps, blit=True)
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        ani.save(save_path, writer="pillow", fps=fps, dpi=80)
        plt.close(fig)
    return ani


# per-band training diagnostics


def plot_subband_edc(
    h_true: np.ndarray,
    h_approx: Sequence[np.ndarray],
    fs: float,
    band_centre_hz: Sequence[float],
    pos_to_investigate: Optional[Sequence[float]] = None,
    epoch_numbers: Optional[Sequence[int]] = None,
    mixing_time_ms: float = 20.0,
    crop_end_ms: float = 5.0,
    save_path: Optional[str] = None,
):
    """Octave-band EDCs of the true RIR and of the synthesized RIR of each epoch."""
    from ..analysis import octave_filtering, schroeder_edc
    from ..ops.basic import ms_to_samps

    mix = ms_to_samps(mixing_time_ms, fs)
    crop = ms_to_samps(crop_end_ms, fs)
    true_trunc = np.asarray(h_true)[mix:-crop]
    filt_true = octave_filtering(true_trunc, fs, list(band_centre_hz))
    t = np.arange(len(true_trunc)) / fs
    n_bands = len(band_centre_hz)
    if epoch_numbers is None:
        epoch_numbers = list(range(-1, len(h_approx) - 1))

    fig, ax = pyplot().subplots(n_bands, 1, figsize=(6, 2 * n_bands), sharex=True)
    ax = np.atleast_1d(ax)
    for k in range(n_bands):
        ax[k].plot(t, db_np(schroeder_edc(filt_true[:, k]) + 1e-20, is_squared=True), "k",
                   label="Reference")
        ax[k].set_title(f"{band_centre_hz[k]:.0f} Hz")
        ax[k].set_ylim(-80, 5)
    for e, h in enumerate(h_approx):
        filt = octave_filtering(np.asarray(h)[mix : mix + len(true_trunc)], fs,
                                list(band_centre_hz))
        for k in range(n_bands):
            ax[k].plot(t[: filt.shape[0]],
                       db_np(schroeder_edc(filt[:, k]) + 1e-20, is_squared=True),
                       label=f"Epoch={epoch_numbers[e]}", linewidth=0.8)
    ax[-1].set_xlabel("Time (s)")
    fig.supylabel("Energy decay (dB)")
    ax[0].legend(fontsize=6, loc="upper right")
    if pos_to_investigate is not None:
        p = np.asarray(pos_to_investigate)
        fig.suptitle(f"Truncated EDF at ({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f}) m")
    fig.subplots_adjust(hspace=0.7)
    return save_or_show(fig, save_path)


def plot_subband_amplitudes(
    h_true: np.ndarray,
    h_approx: np.ndarray,
    fs: float,
    num_groups: int,
    amplitudes: np.ndarray,
    common_decay_times: np.ndarray,
    band_centre_hz: Sequence[float],
    mixing_time_ms: float = 20.0,
    crop_end_ms: float = 5.0,
    save_path: Optional[str] = None,
):
    """Given common-slope amplitudes against the least-squares estimates from
    the true and the synthesized RIR, per band and group. ``amplitudes``:
    (n_bands, 1, n_groups) or (n_bands, n_groups); ``common_decay_times``:
    (n_bands, n_groups)."""
    from ..analysis import get_amps_for_rir

    cdt = np.asarray(common_decay_times)
    bands = list(band_centre_hz)
    theo = np.asarray(amplitudes).reshape(len(bands), -1)
    est_true, est_approx = (
        get_amps_for_rir(np.asarray(h), cdt.T, bands, fs, mixing_time_ms=mixing_time_ms,
                         leave_out_ms=crop_end_ms).reshape(len(bands), -1)
        for h in (h_true, h_approx)
    )
    fig, ax = pyplot().subplots(num_groups, 1, figsize=(6, 3 * num_groups))
    ax = np.atleast_1d(ax)
    for g in range(num_groups):
        ax[g].semilogx(bands, db_np(theo[:, g] + 1e-12, is_squared=True), marker="o",
                       label="Theoretical")
        ax[g].semilogx(bands, db_np(est_true[:, g] + 1e-12, is_squared=True), marker="d",
                       label="True RIR, LS estimate")
        ax[g].semilogx(bands, db_np(est_approx[:, g] + 1e-12, is_squared=True), marker="x",
                       label="Synthesized RIR, LS estimate")
        ax[g].set_title(f"Group {g + 1}")
        ax[g].set_ylim(-80, 10)
        ax[g].grid(True, which="both", alpha=0.3)
        ax[g].set_ylabel("Magnitude (dB)")
    ax[-1].set_xlabel("Frequency (Hz)")
    ax[0].legend(fontsize=7)
    fig.subplots_adjust(hspace=0.5)
    return save_or_show(fig, save_path)


def plot_beamformer_map(
    est_amps: np.ndarray,
    sph_directions: np.ndarray,
    ambi_order: int,
    num_groups: int,
    save_path: Optional[str] = None,
    db_limits: Optional[np.ndarray] = None,
    grid_size: Tuple[int, int] = (20, 20),
) -> np.ndarray:
    """Directional common-slope amplitudes at one position, projected onto
    spherical harmonics and contoured per group on a dense (azimuth, polar)
    grid. ``est_amps``: (num_directions, num_groups); ``sph_directions``: (2,
    num_directions) as (azimuth, elevation), the dataset's convention.
    Returns the (2, num_groups) dB limits used, reusable across figures."""
    from ..ops.sph import sh_matrix

    est_amps = np.asarray(est_amps)
    num_dirs = est_amps.shape[0]
    azi = np.linspace(0.0, 2.0 * np.pi, grid_size[0])
    polar = np.linspace(0.0, np.pi, grid_size[1])
    azi_g, pol_g = np.meshgrid(azi, polar)

    y_orig = sh_matrix(ambi_order, sph_directions[0], np.pi / 2 - sph_directions[1])
    y_dense = sh_matrix(ambi_order, azi_g.ravel(), pol_g.ravel())
    weights = (y_orig.T / num_dirs) @ est_amps  # (n_sh, n_groups)
    interp = (y_dense @ weights).reshape(*azi_g.shape, -1)
    interp_db = db_np(np.abs(interp) + 1e-12, is_squared=True)

    if db_limits is None:
        flat = interp_db.reshape(-1, num_groups)
        db_limits = np.stack([flat.min(axis=0), flat.max(axis=0)])
    fig, ax = pyplot().subplots(num_groups, 1, figsize=(6, 3 * num_groups))
    ax = np.atleast_1d(ax)
    for k in range(num_groups):
        surf = ax[k].contourf(np.degrees(azi_g), np.degrees(pol_g), interp_db[..., k],
                              vmin=db_limits[0, k], vmax=db_limits[1, k], cmap="plasma")
        fig.colorbar(surf, ax=ax[k], shrink=0.8).set_label("dB")
        ax[k].set_xlabel("Azimuth (deg)")
        ax[k].set_ylabel("Polar angle (deg)")
        ax[k].set_title(f"Group {k + 1}")
    fig.subplots_adjust(hspace=0.5)
    save_or_show(fig, save_path)
    return db_limits


def animate_moving_listener(
    receiver_path: np.ndarray,
    room_dims: Sequence,
    room_start_coords: Sequence,
    yaw_angles: Optional[np.ndarray] = None,
    source_position: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    fps: int = 25,
):
    """Top-down animation of a listener walking ``receiver_path`` over the
    floor plan, with a yaw arrow when ``yaw_angles`` are given. Saved as an
    .mp4 through ffmpeg where it is installed, else as a .gif (pillow) beside
    ``save_path``."""
    from matplotlib import animation

    plt = pyplot()
    path = np.asarray(receiver_path)
    fig, ax = plt.subplots(figsize=(6, 6))
    draw_room_boundaries(ax, room_dims, room_start_coords)
    if source_position is not None:
        ax.plot(source_position[0], source_position[1], "r*", markersize=12, label="source")
    ax.plot(path[:, 0], path[:, 1], "k--", alpha=0.4, linewidth=0.8)
    marker = plt.Circle((path[0, 0], path[0, 1]), 0.12, color="tab:blue")
    ax.add_patch(marker)
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")

    arrows = []
    arrow_len = 0.4

    def draw_arrow(frame):
        yaw = yaw_angles[frame]
        return ax.arrow(path[frame, 0], path[frame, 1], arrow_len * np.cos(yaw),
                        arrow_len * np.sin(yaw), head_width=0.1, head_length=0.1,
                        fc="tab:blue", ec="tab:blue")

    if yaw_angles is not None:
        arrows.append(draw_arrow(0))

    def update(frame):
        marker.set_center((path[frame, 0], path[frame, 1]))
        artists = [marker]
        if yaw_angles is not None:
            arrows[0].remove()
            arrows[0] = draw_arrow(frame)
            artists.append(arrows[0])
        return artists

    ani = animation.FuncAnimation(fig, update, frames=len(path), interval=1000 // fps,
                                  blit=True)
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        try:
            ani.save(save_path, writer=animation.FFMpegWriter(fps=fps))
        except (FileNotFoundError, RuntimeError):  # no ffmpeg: a GIF instead
            ani.save(str(Path(save_path).with_suffix(".gif")), writer="pillow",
                     fps=min(fps, 10), dpi=80)
        plt.close(fig)
    return ani


def plot_edr(
    rir,
    fs: float,
    win_size: int = 512,
    hop_size: int = 256,
    log_freq_axis: bool = False,
    title: Optional[str] = None,
    save_path: Optional[str] = None,
) -> np.ndarray:
    """EDR waterfall of an RIR in dB; returns the EDR (F, n_frames).

    The STFT and the backward cumulative per-bin energy (``ops/stft.py``)
    run in float32 on the device of ``rir`` when it is a tensor, on the CPU
    for a numpy array."""
    from ..ops.stft import edr_from_stft, stft

    x = rir if isinstance(rir, torch.Tensor) else torch.as_tensor(np.asarray(rir, np.float32))
    edr = edr_from_stft(stft(x.to(torch.float32), win_size, hop_size)).cpu().numpy()
    freqs = np.fft.rfftfreq(win_size, 1.0 / fs)
    times = hop_size * np.arange(edr.shape[-1]) / fs
    fig, ax = pyplot().subplots(figsize=(7, 4))
    im = ax.pcolormesh(times, freqs, edr, shading="auto", cmap="magma")
    fig.colorbar(im, ax=ax, label="EDR [dB]")
    if log_freq_axis:
        ax.set_yscale("log")
        ax.set_ylim(freqs[1], fs / 2)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [Hz]")
    if title:
        ax.set_title(title)
    save_or_show(fig, save_path)
    return edr


def plot_learned_svf_response(
    output_biquad_coeffs,
    fs: float,
    pos_to_investigate: Optional[Sequence[float]] = None,
    epoch_numbers: Optional[Sequence[int]] = None,
    save_path: Optional[str] = None,
):
    """Magnitude responses and poles / zeros of learned output SVF cascades.

    ``output_biquad_coeffs``: one (num_groups, n_sections, 6) array, or a
    list of them (one per checkpoint epoch). Per group, the cascade's
    magnitude on a log-frequency axis and the sections' poles (x) and zeros
    (o) on a polar plot; with ``save_path``, saved as
    ``{stem}_output_filter_response.png`` and ``{stem}_output_filter_pz_plot.png``.
    """
    from ..ops.biquad import sos_response_np

    plt = pyplot()
    per_epoch = (list(output_biquad_coeffs) if isinstance(output_biquad_coeffs, (list, tuple))
                 else [output_biquad_coeffs])
    num_groups = int(np.asarray(per_epoch[0]).shape[0])
    labels = list(epoch_numbers) if epoch_numbers is not None else list(range(len(per_epoch)))
    fig, axes = plt.subplots(num_groups, 1, figsize=(6, 2.6 * num_groups), squeeze=False)
    figp, axesp = plt.subplots(num_groups, 1, subplot_kw={"projection": "polar"},
                               figsize=(6, 3.0 * num_groups), squeeze=False)
    freqs = np.geomspace(20.0, fs / 2 * 0.95, 512)
    for epoch, coeffs in zip(labels, per_epoch):
        coeffs = np.asarray(coeffs, np.float64)
        for g in range(num_groups):
            sos = coeffs[g] / coeffs[g][:, 3:4]  # normalize a0 = 1
            axes[g, 0].semilogx(freqs, db_np(sos_response_np(sos, freqs, fs)), alpha=0.8,
                                label=f"epoch {epoch}")
            zeros = np.concatenate([np.roots(sec[:3]) for sec in sos])
            poles = np.concatenate([np.roots(sec[3:]) for sec in sos])
            axesp[g, 0].plot(np.angle(zeros), np.abs(zeros), "o", alpha=0.7,
                             label=f"zeros e{epoch}")
            axesp[g, 0].plot(np.angle(poles), np.abs(poles), "x", alpha=0.7,
                             label=f"poles e{epoch}")
    where = f" at position {list(pos_to_investigate)}" if pos_to_investigate is not None else ""
    for g in range(num_groups):
        axes[g, 0].set_xlabel("frequency [Hz]")
        axes[g, 0].set_ylabel("magnitude [dB]")
        axes[g, 0].set_title(f"output filter, group {g + 1}{where}")
        axes[g, 0].grid(alpha=0.3, which="both")
        axesp[g, 0].set_rmax(1.05)
        axesp[g, 0].set_rticks([0.25, 0.5, 1.0])
        axesp[g, 0].grid(True)
    axes[0, 0].legend(loc="lower right", fontsize=7)
    fig.tight_layout()
    figp.tight_layout()
    if save_path is not None:
        base = Path(save_path)
        base.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(base.parent / f"{base.stem}_output_filter_response.png",
                    bbox_inches="tight", dpi=150)
        figp.savefig(base.parent / f"{base.stem}_output_filter_pz_plot.png",
                     bbox_inches="tight", dpi=150)
        plt.close(fig)
        plt.close(figp)
    return fig, figp
