"""6DoF rendering: moving-receiver convolution and binaural SH rendering
(port of ``diffgfdn_tpu/inference/rendering.py``).

Reference behaviour: src/sound_examples.py:25-539 —
* :func:`add_direct_and_early_path` — splice measured direct/early parts
  onto synthesized late tails with crossfades and energy matching;
* :class:`DynamicRenderingMovingReceiver` — time-varying overlap-add
  convolution with linear crossfades as the listener moves;
* :class:`BinauralDynamicRendering` — SH-domain head rotation +
  conj(HRTF-SH) beamforming per hop with sqrt (uncorrelated) crossfades;
* :func:`normalise_loudness` — BS.1770-style K-weighted loudness
  normalization (replaces pyloudnorm).

``BinauralDynamicRendering.binaural_filter_overlap_add()`` renders every
hop of a walk in one batched program on the renderer's ``device`` (CUDA
unless the caller asks for the CPU): the hop loop's only sequential state (one-hop smoothing of the
rotation matrix and RTF, and the previous segment's crossfade tail) has a
closed form, so all hops batch into SH rotations, beamforming einsums, FFTs
of every hop segment and an overlap-add of slice-adds. It gives the output of the
host loop, :meth:`BinauralDynamicRendering.stream_host` (numpy, streaming
playback tooling, which keeps the previous hop's rotation and RTF across
calls), from a fresh renderer. The program has a leading trajectory
axis: :meth:`BinauralDynamicRendering.binaural_filter_overlap_add_multi`
renders B walks at once, and the single render is B = 1 of it. The SH
rotation matrices are built on the host in float64 (one Ivanic-Ruedenberg
recursion per hop) and uploaded as float32.
"""

import os
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
from scipy.signal import fftconvolve, lfilter
import torch
import torch.nn.functional as F

from ..data.room_dataset import early_late_split
from ..ops.basic import ms_to_samps
from ..ops.sph import sh_rotation_yaw_pitch_roll
from ..utils.device import resolve_device
from .cs_synthesis import calculate_energy_envelope

Device = Union[str, torch.device]


def add_direct_and_early_path(
    ref_rirs: np.ndarray,
    ref_positions: np.ndarray,
    late_rirs: np.ndarray,
    positions: np.ndarray,
    sample_rate: float,
    mixing_time_ms: float = 50.0,
    win_len_ms: float = 5.0,
) -> np.ndarray:
    """Splice measured early parts onto synthesized late tails.

    ``ref_rirs``: (R_ref, [C,] T) measured set; ``late_rirs``: ([R,] [C,] T)
    synthesized tails at ``positions``. The early part comes from the
    nearest measured receiver; the late gain is matched at the mixing time
    using short-time energy envelopes; both sides are crossfaded
    (reference: sound_examples.py:25-77). Host numpy; the envelopes are
    ``cs_synthesis.calculate_energy_envelope`` on CPU float64 tensors.
    """

    def envelope(x: np.ndarray) -> np.ndarray:
        return calculate_energy_envelope(
            torch.from_numpy(np.asarray(x, np.float64)), sample_rate, 20
        ).numpy()

    d = np.linalg.norm(ref_positions[:, None, :] - positions[None], axis=-1)
    closest = np.argmin(d, axis=0)

    mix = ms_to_samps(mixing_time_ms, sample_rate)
    wl = ms_to_samps(2 * win_len_ms, sample_rate)
    window = np.hanning(wl)
    fade_out = window[wl // 2 :]
    fade_in = window[: wl // 2]

    early = np.zeros_like(late_rirs)
    early[..., : mix + wl // 2] = ref_rirs[closest][..., : mix + wl // 2]
    late = np.zeros_like(late_rirs)
    late[..., mix:] = late_rirs[..., mix:]

    early_env = envelope(early[..., :mix])
    late_env = envelope(late[..., mix:])
    gain = np.sqrt(
        early_env[..., -1:] / (late_env[..., :1] + 1e-12)
    )
    late = late * gain

    early[..., mix : mix + wl // 2] *= fade_out
    late[..., mix : mix + wl // 2] *= fade_in
    return early + late


def fade_windows(
    win_len_samps: int, fade_out: bool = False, uncorr_fade: bool = False
) -> np.ndarray:
    """Linear fades; sqrt version for uncorrelated (binaural) material."""
    n = np.linspace(-1.0, 1.0, win_len_samps)
    fade = 0.5 * (1.0 + (1.0 - 2.0 * float(fade_out)) * n)
    return np.sqrt(fade) if uncorr_fade else fade


def k_weighting_coeffs(fs: float) -> List[Tuple[np.ndarray, np.ndarray]]:
    """BS.1770 K-weighting: high-shelf + high-pass biquads at rate fs."""
    # stage 1: shelving (+4 dB high shelf)
    f0, g_db, q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    k = np.tan(np.pi * f0 / fs)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b_shelf = np.array(
        [(vh + vb * k / q + k * k), 2.0 * (k * k - vh), (vh - vb * k / q + k * k)]
    ) / a0
    a_shelf = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    # stage 2: high pass
    f0, q = 38.13547087602444, 0.5003270373238773
    k = np.tan(np.pi * f0 / fs)
    denom = 1.0 + k / q + k * k
    b_hp = np.array([1.0, -2.0, 1.0])
    a_hp = np.array(
        [1.0, 2.0 * (k * k - 1.0) / denom, (1.0 - k / q + k * k) / denom]
    )
    return [(b_shelf, a_shelf), (b_hp, a_hp)]


def integrated_loudness(signal: np.ndarray, fs: float) -> float:
    """Gated BS.1770 integrated loudness in LUFS (mono or (T, C))."""
    x = signal if signal.ndim == 2 else signal[:, None]
    for b, a in k_weighting_coeffs(fs):
        x = lfilter(b, a, x, axis=0)
    block = int(0.4 * fs)
    hop = int(0.1 * fs)
    n_blocks = max(1, (x.shape[0] - block) // hop + 1)
    ms = np.array(
        [np.mean(x[i * hop : i * hop + block] ** 2, axis=0).sum() for i in range(n_blocks)]
    )
    loud = -0.691 + 10.0 * np.log10(ms + 1e-12)
    gate1 = loud > -70.0
    if not gate1.any():
        return -70.0
    rel = -0.691 + 10.0 * np.log10(np.mean(ms[gate1]) + 1e-12) - 10.0
    gate2 = gate1 & (loud > rel)
    if not gate2.any():
        gate2 = gate1
    return float(-0.691 + 10.0 * np.log10(np.mean(ms[gate2]) + 1e-12))


def normalise_loudness(
    signal: np.ndarray, fs: float, db_lufs: float = -18.0
) -> np.ndarray:
    """Scale the signal to the target integrated loudness."""
    cur = integrated_loudness(signal, fs)
    return signal * 10.0 ** ((db_lufs - cur) / 20.0)


class DynamicRenderingMovingReceiver:
    """Time-varying convolution for a listener moving over the RIR grid.

    Reference: sound_examples.py:80-353; :meth:`animate_trajectory` draws
    the walk (matplotlib).
    """

    def __init__(
        self,
        room_dataset,
        rec_pos_list: np.ndarray,
        stimulus: np.ndarray,
        update_ms: float = 100.0,
    ):
        self.room = room_dataset
        self.sample_rate = room_dataset.sample_rate
        self.rec_pos_list = np.asarray(rec_pos_list)
        self.num_pos = self.rec_pos_list.shape[0]
        self.update_ms = update_ms
        self.hop_size = ms_to_samps(update_ms, self.sample_rate)
        self.stimulus = np.asarray(stimulus, np.float32)
        self.extended_stimulus = self._extend_stimulus()

    @property
    def total_sim_len(self) -> int:
        return self.num_pos * self.hop_size

    @property
    def rec_idxs(self) -> np.ndarray:
        return self.room.find_rec_idx(self.rec_pos_list)

    def _extend_stimulus(self) -> np.ndarray:
        total = self.total_sim_len
        reps = int(np.ceil(total / len(self.stimulus)))
        return np.tile(self.stimulus, reps)[:total]

    def animate_trajectory(self, save_path: str, yaw_angles: Optional[np.ndarray] = None):
        """The walk as a floor-plan animation at the renderer's hop rate: an
        .mp4 (ffmpeg) or, without ffmpeg, a .gif beside ``save_path``
        (``utils/plot.py animate_moving_listener``)."""
        from ..utils.plot import animate_moving_listener

        return animate_moving_listener(
            self.rec_pos_list,
            room_dims=self.room.room_dims,
            room_start_coords=self.room.room_start_coord,
            yaw_angles=yaw_angles,
            source_position=np.asarray(self.room.source_position).reshape(-1),
            save_path=save_path,
            fps=max(1, int(round(1000.0 / self.update_ms))),
        )

    def _rirs(self, use_whole_rir: bool) -> np.ndarray:
        if use_whole_rir:
            return self.room.rirs[self.rec_idxs]
        _, late = early_late_split(
            self.room.rirs, self.room.mixing_time_ms, self.sample_rate
        )
        full_late = np.zeros_like(self.room.rirs)
        mix = ms_to_samps(self.room.mixing_time_ms, self.sample_rate)
        full_late[..., mix:] = late
        return full_late[self.rec_idxs]

    def filter_overlap_add(
        self,
        use_whole_rir: bool = False,
        alpha: float = 0.5,
        fade_len_ms: float = 50.0,
    ) -> np.ndarray:
        """Convolve hop-wise with position-interpolated RIRs + crossfades."""
        rirs = self._rirs(use_whole_rir)
        out = np.zeros_like(self.extended_stimulus)
        fade_len = ms_to_samps(fade_len_ms, self.sample_rate)
        f_out = fade_windows(fade_len, fade_out=True)
        f_in = fade_windows(fade_len, fade_out=False)
        prev_tail = np.zeros(fade_len)
        prev_filter = None

        for k in range(self.num_pos):
            sl = slice(k * self.hop_size, min((k + 1) * self.hop_size, len(out)))
            cur_filter = rirs[k]
            if prev_filter is not None:
                cur_filter = alpha * cur_filter + (1 - alpha) * prev_filter
            prev_filter = cur_filter

            seg = fftconvolve(self.extended_stimulus[sl], cur_filter, mode="full")
            start = k * self.hop_size
            end = min(start + len(seg), len(out))
            seg = seg[: end - start]
            if k > 0:
                ov = min(fade_len, len(seg))
                out[start : start + ov] += (
                    prev_tail[:ov] * f_out[:ov] + seg[:ov] * f_in[:ov]
                )
                out[start + ov : end] += seg[ov:]
            else:
                out[start:end] += seg
            if len(seg) >= fade_len:
                prev_tail[:] = seg[-fade_len:]
            else:
                prev_tail[: len(seg)] = seg
        return out


class BinauralDynamicRendering(DynamicRenderingMovingReceiver):
    """Moving listener + rotating head: SH rotation, HRTF-SH beamforming.

    ``room_dataset`` must hold ambisonic RIRs (num_pos, (N+1)^2, T);
    ``orientation_list``: (num_pos, 2) yaw/pitch in radians. Reference:
    sound_examples.py:356-539. ``device`` is where the batched renders
    (:meth:`binaural_filter_overlap_add` and
    :meth:`binaural_filter_overlap_add_multi`) run: CUDA unless the caller
    asks for the CPU; it is resolved when they first run, so the streaming
    host loop (:meth:`stream_host`) needs no card.
    """

    def __init__(
        self,
        room_dataset,
        rec_pos_list: np.ndarray,
        orientation_list: np.ndarray,
        stimulus: np.ndarray,
        hrir_sh: np.ndarray,
        update_ms: float = 100.0,
        use_whole_rir: bool = False,
        mixing_time_ms: float = 50.0,
        device: Device = "cuda",
    ):
        super().__init__(room_dataset, rec_pos_list, stimulus, update_ms)
        self.orientation_list = np.asarray(orientation_list, np.float64).copy()
        self.orientation_list[:, -1] = -self.orientation_list[:, -1]  # pitch
        if self.orientation_list.shape[0] != self.num_pos:
            raise ValueError(f"{self.orientation_list.shape[0]} orientations for "
                             f"{self.num_pos} positions")
        self.use_whole_rir = use_whole_rir
        self.ambi_order = int(np.sqrt(room_dataset.rirs.shape[1]) - 1)
        self.mixing_time_ms = mixing_time_ms
        self.hrir_sh = hrir_sh  # (n_sh, 2, T)
        self.device = device
        self._init_freq_domain()

    def _init_freq_domain(self):
        self.num_freq_bins = int(2 ** np.ceil(np.log2(self.room.rir_length)))
        rirs = self.room.rirs
        if not self.use_whole_rir:
            _, late = early_late_split(
                rirs, self.mixing_time_ms, self.sample_rate, win_len_ms=10.0
            )
            rirs = np.concatenate(
                [np.zeros(rirs.shape[:-1] + (rirs.shape[-1] - late.shape[-1],)), late],
                axis=-1,
            )
        # FFT each UNIQUE receiver once; hops revisiting a grid point share
        # the spectrum (trajectories typically dwell on few grid cells)
        uniq, inv = np.unique(self.rec_idxs, return_inverse=True)
        self._rtf_uniq = np.fft.rfft(rirs[uniq], self.num_freq_bins, axis=-1)
        self._rtf_inv = inv.astype(np.int32)
        self.ambi_hrtfs = np.fft.rfft(self.hrir_sh, self.num_freq_bins, axis=-1)
        self._prev_rot = None
        self._prev_rtf = None
        self._dev_consts = None  # unique-receiver RTFs and HRTF-SH on the device
        self._dict_consts = None  # beamformed-RTF dictionary (device)
        self._ola_consts = None  # the overlap-add's gather index and fades (device)
        # dictionary-path override: None = auto (fits the memory budget),
        # True/False = force. See _use_dict_path.
        self.dict_path: Optional[bool] = None

    def get_binaural_rir(
        self, head_orientation: Tuple[float, float], rec_pos_idx: int,
        alpha: float = 0.5,
    ) -> np.ndarray:
        """(num_freq_bins, 2) BRIR for one hop (rotation + HRTF-SH conv)."""
        cur_rtf = self._rtf_uniq[self._rtf_inv[rec_pos_idx]]
        rot = sh_rotation_yaw_pitch_roll(
            self.ambi_order, -head_orientation[0], -head_orientation[1], 0.0
        )
        w_rot = rot if self._prev_rot is None else alpha * rot + (1 - alpha) * self._prev_rot
        w_rtf = cur_rtf if self._prev_rtf is None else alpha * cur_rtf + (1 - alpha) * self._prev_rtf
        rotated = w_rtf.T @ w_rot.T  # (F, n_sh)
        brtf = np.einsum("nrf,fn->fr", np.conj(self.ambi_hrtfs), rotated)
        self._prev_rot = rot
        self._prev_rtf = cur_rtf
        return np.fft.irfft(brtf, self.num_freq_bins, axis=0)

    def binaural_filter_overlap_add(self, backend: str = "device") -> np.ndarray:
        """Hop-wise binaural convolution with sqrt crossfades -> (T, 2).

        ``backend="device"`` (the default) renders every hop in ONE batched
        program on the renderer's device, from fresh smoothing state as on
        a first :meth:`stream_host` call; ``backend="host"`` is
        :meth:`stream_host`. Both return host float64.
        """
        if backend == "host":
            return self.stream_host()
        if backend != "device":
            raise ValueError(f"unknown backend {backend!r}")
        inputs = self.device_inputs(self.extended_stimulus[None], self.orientation_list[None])
        return self.render_device(*inputs)[0].cpu().numpy().astype(np.float64)

    def stream_host(self) -> np.ndarray:
        """The streaming host loop -> (T, 2) float64: numpy, hop by hop, for
        real-time playback. Stateful: the previous hop's rotation and RTF
        carry across calls (:meth:`get_binaural_rir`), so a second call
        smooths its first hop with the first call's last."""
        out = np.zeros((len(self.extended_stimulus), 2))
        fade_len = ms_to_samps(self.update_ms, self.sample_rate)
        f_out = fade_windows(fade_len, fade_out=True, uncorr_fade=True)
        f_in = fade_windows(fade_len, fade_out=False, uncorr_fade=True)
        prev_tail = np.zeros((fade_len, 2))

        for k in range(self.num_pos):
            sl = slice(k * self.hop_size, min((k + 1) * self.hop_size, len(out)))
            stim = self.extended_stimulus[sl]
            brir = self.get_binaural_rir(self.orientation_list[k], k)
            start = k * self.hop_size
            for j in range(2):
                seg = fftconvolve(stim, brir[:, j], mode="full")
                end = min(start + len(seg), out.shape[0])
                seg = seg[: end - start]
                if k > 0:
                    ov = min(fade_len, len(seg))
                    out[start : start + ov, j] += (
                        prev_tail[:ov, j] * f_out[:ov] + seg[:ov] * f_in[:ov]
                    )
                    out[start + ov : end, j] += seg[ov:]
                else:
                    out[start:end, j] += seg
                if len(seg) >= fade_len:
                    prev_tail[:, j] = seg[-fade_len:]
                else:
                    prev_tail[: len(seg), j] = seg
        return out

    def binaural_filter_overlap_add_multi(
        self,
        stimuli: np.ndarray,
        orientations: Optional[np.ndarray] = None,
        rec_indices: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Render B trajectories/stimuli in ONE device program -> (B, T, 2).

        ``stimuli``: (B, num_pos * hop) extended stimuli (one per
        trajectory). ``orientations``: optional (B, num_pos, 2) yaw/pitch
        lists (defaults to this renderer's list for every trajectory).
        ``rec_indices``: optional (B, num_pos) indices into THIS renderer's
        hop positions (defaults to the renderer's own receiver path).
        Each trajectory's output equals :meth:`binaural_filter_overlap_add`'s
        for it.
        Returns host float64.
        """
        stimuli = np.asarray(stimuli, np.float32)
        if orientations is None:
            orientations = np.broadcast_to(
                np.asarray(self.orientation_list, np.float32),
                (stimuli.shape[0], self.num_pos, 2),
            )
        else:
            # same convention as the constructor: stored pitch is negated
            orientations = np.asarray(orientations, np.float64).copy()
            orientations[..., -1] = -orientations[..., -1]
        inputs = self.device_inputs(stimuli, orientations, rec_indices)
        return self.render_device(*inputs).cpu().numpy().astype(np.float64)

    def device_inputs(
        self,
        stimuli: np.ndarray,
        orientations: np.ndarray,
        rec_indices: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The host half of a batched render of B walks: (B, K, hop) stimulus
        segments, (B, K, S, S) float32 one-hop-smoothed SH rotations (one
        recursion per hop and walk, from ``orientations`` (B, K, 2) in the
        stored convention: pitch negated) and (B, K) indices into the unique
        receivers (``rec_indices`` index the renderer's hops)."""
        stimuli = np.asarray(stimuli, np.float32)
        b = stimuli.shape[0]
        k_hops, hop = self.num_pos, self.hop_size
        if ms_to_samps(self.update_ms, self.sample_rate) != hop:
            raise ValueError("binaural fades are one hop long by construction")
        if stimuli.shape[1] != k_hops * hop:
            raise ValueError(f"stimuli {stimuli.shape}: want (B, {k_hops * hop})")
        rots = np.stack([
            np.stack([
                sh_rotation_yaw_pitch_roll(self.ambi_order, -yaw, -pitch, 0.0)
                for yaw, pitch in traj
            ])
            for traj in np.asarray(orientations)
        ])  # (B, K, S, S)
        w_rot = np.concatenate(
            [rots[:, :1], 0.5 * (rots[:, 1:] + rots[:, :-1])], axis=1
        ).astype(np.float32)
        if rec_indices is None:
            inv = np.broadcast_to(self._rtf_inv, (b, k_hops))
        else:
            inv = self._rtf_inv[np.asarray(rec_indices)]
        return stimuli.reshape(b, k_hops, hop), w_rot, np.array(inv)

    def render_device(self, segs: np.ndarray, w_rot: np.ndarray, inv: np.ndarray) -> torch.Tensor:
        """The device half of a batched render: (B, K*hop, 2) float32 on the
        renderer's device, from :meth:`device_inputs`' arrays, through the
        dictionary program or the einsum program (:meth:`_use_dict_path`)."""
        dev = resolve_device(self.device)
        segs_t = torch.as_tensor(segs, device=dev)
        ola = self._ensure_ola_consts()
        if self._use_dict_path():
            dictionary = self._ensure_dict_consts()
            coef = np.stack([self._dict_coefs(w, i) for w, i in zip(w_rot, inv)])
            return binaural_dict_program(segs_t, torch.as_tensor(coef, device=dev), dictionary,
                                         self.num_freq_bins, ola)
        rtf, hf = self._ensure_dev_consts()
        return binaural_einsum_program(
            segs_t, torch.as_tensor(w_rot, device=dev), rtf,
            torch.as_tensor(inv, dtype=torch.long, device=dev), hf, self.num_freq_bins, ola)

    def _ensure_dev_consts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The unique receivers' RTFs (U, S, F) and the HRTF-SH set (S, 2, F),
        complex64 on the device, uploaded once: the per-call program starts at
        the rotation products, as the host path's RTFs are precomputed in
        _init_freq_domain."""
        if self._dev_consts is None:
            dev = resolve_device(self.device)
            self._dev_consts = tuple(
                torch.as_tensor(np.asarray(a, np.complex64), device=dev)
                for a in (self._rtf_uniq, self.ambi_hrtfs)
            )
        return self._dev_consts

    def _ensure_ola_consts(self) -> "OLAConstants":
        if self._ola_consts is None:
            seg_len = _conv_len(self.hop_size, self.num_freq_bins)[0]
            self._ola_consts = ola_constants(self.num_pos, self.hop_size, seg_len,
                                             resolve_device(self.device))
        return self._ola_consts

    def _conv_nfft(self) -> int:
        """FFT size of the hop-convolution stage (power of two covering
        one hop + the padded BRIR length)."""
        return _conv_len(self.hop_size, self.num_freq_bins)[1]

    def _dict_nbytes(self) -> int:
        """Device bytes of the beamformed-atom dictionary (re+im f32)."""
        u, s = self._rtf_uniq.shape[:2]
        n = self.ambi_hrtfs.shape[0]
        f2 = self._conv_nfft() // 2 + 1
        return u * s * n * 2 * f2 * 8

    def _use_dict_path(self) -> bool:
        """Select the dictionary render program (see _ensure_dict_consts).

        Auto policy: use it whenever the dictionary fits the device memory
        budget (``DIFFGFDN_BINAURAL_DICT_MB``, default 512 MB), as the JAX
        package does: it removes the per-hop rotation/beamforming einsums
        AND the BRIR irfft→rfft roundtrip from the hot program. Override
        with ``self.dict_path``.
        """
        if self.dict_path is not None:
            return bool(self.dict_path)
        budget_mb = float(os.environ.get("DIFFGFDN_BINAURAL_DICT_MB", 512.0))
        return self._dict_nbytes() <= budget_mb * 2.0 ** 20

    def _ensure_dict_consts(self) -> torch.Tensor:
        """Build the beamformed-RTF dictionary on the device once.

        Atom (u, s, n) is the binaural spectrum — at the CONVOLUTION fft
        size — of unique-receiver ``u``'s ambi channel ``s`` beamformed
        through conj(HRTF-SH) channel ``n``:
        ``D[(u,s,n), r, f2] = rfft(irfft(rtf_u[s]·conj(hf[n,r]), nfft),
        nfft2)``. Rotation + one-hop smoothing act LINEARLY on these
        atoms, so every hop's convolution-ready BRTF is one real matrix
        product ``coef (K, J) @ D (J, 2·F2·2)``. Returned as the real view of
        the complex atoms, (J, 2·F2·2) float32; built one unique receiver at
        a time from the device constants, so the build's peak is the
        dictionary and one receiver's atoms.
        """
        if self._dict_consts is None:
            rtf, hf = self._ensure_dev_consts()
            nfft2 = self._conv_nfft()
            hfc = hf.conj()
            u, s = rtf.shape[:2]
            n = hf.shape[0]
            atoms_per_u = s * n
            dictionary = torch.empty((u * atoms_per_u, 2 * (nfft2 // 2 + 1) * 2),
                                     dtype=torch.float32, device=rtf.device)
            for k in range(u):
                atoms = rtf[k][:, None, None, :] * hfc[None]  # (S, N, 2, F)
                atoms_t = torch.fft.irfft(atoms, self.num_freq_bins, dim=-1)
                d2 = torch.fft.rfft(atoms_t, nfft2, dim=-1)  # (S, N, 2, F2)
                dictionary[k * atoms_per_u:(k + 1) * atoms_per_u] = (
                    torch.view_as_real(d2).reshape(atoms_per_u, -1))
            self._dict_consts = dictionary
        return self._dict_consts

    def _dict_coefs(self, w_rot: np.ndarray, inv: np.ndarray) -> np.ndarray:
        """(K, J) real mixing weights onto the dictionary atoms:
        ``A[k,(u,s,n)] = W[k,u] · w_rot[k,n,s]`` where ``W`` carries the
        one-hop RTF smoothing (one-hot at k=0, half on the previous hop's
        receiver after). Atom ordering matches _ensure_dict_consts."""
        k_hops = w_rot.shape[0]
        u = self._rtf_uniq.shape[0]
        w = np.zeros((k_hops, u), np.float32)
        w[0, inv[0]] = 1.0
        if k_hops > 1:
            rows = np.arange(1, k_hops)
            np.add.at(w, (rows, inv[1:k_hops]), 0.5)
            np.add.at(w, (rows, inv[: k_hops - 1]), 0.5)
        a = np.einsum("ku,kns->kusn", w, np.asarray(w_rot, np.float32))
        return np.ascontiguousarray(a.reshape(k_hops, -1))


def _conv_len(hop: int, nfft: int) -> Tuple[int, int]:
    """(segment length, convolution FFT size) of a hop convolved with an
    nfft-tap BRIR."""
    seg_len = hop + nfft - 1
    return seg_len, 1 << (seg_len - 1).bit_length()


def binaural_einsum_program(
    segs: torch.Tensor, w_rot: torch.Tensor, rtf: torch.Tensor, inv: torch.Tensor,
    hf: torch.Tensor, nfft: int, ola: "OLAConstants",
) -> torch.Tensor:
    """All-hops binaural render of B walks: (B, K, hop) stimulus segments,
    (B, K, S, S) smoothed rotations, the unique receivers' RTFs (U, S, F)
    complex64 with a (B, K) gather index, and the HRTF-SH set (S, 2, F)
    complex64 -> (B, K*hop, 2) crossfaded binaural output.

    One-hop smoothing (alpha = 0.5, the host path's default) is applied in
    closed form; the overlap-add and the host loop's end-truncated
    crossfade tails are reproduced exactly (:func:`ola_tail`). The ear axis
    sits before the frequency axis, so every FFT runs along the last axis.
    """
    seg_len, nfft2 = _conv_len(segs.shape[-1], nfft)
    r = rtf[inv]  # (B, K, S, F), unique -> per hop
    w_rtf = torch.cat([r[:, :1], 0.5 * (r[:, 1:] + r[:, :-1])], dim=1)
    # rotated[b,k,n,f] = sum_s w_rot[b,k,n,s] w_rtf[b,k,s,f]; then beamform
    # with conj(HRTF-SH): brtf[b,k,r,f] = sum_n conj(hf[n,r,f]) g[b,k,n,f]
    g = torch.einsum("bkns,bksf->bknf", w_rot.to(rtf.dtype), w_rtf)
    brtf = torch.einsum("nrf,bknf->bkrf", hf.conj(), g)
    brir = torch.fft.irfft(brtf, nfft, dim=-1)  # (B, K, 2, nfft)
    sf = torch.fft.rfft(segs, nfft2, dim=-1)  # (B, K, F2)
    bf = torch.fft.rfft(brir, nfft2, dim=-1)  # (B, K, 2, F2)
    seg_t = torch.fft.irfft(sf[:, :, None] * bf, nfft2, dim=-1)[..., :seg_len]
    return ola_tail(seg_t, ola)


def binaural_dict_program(
    segs: torch.Tensor, coef: torch.Tensor, dictionary: torch.Tensor, nfft: int,
    ola: "OLAConstants",
) -> torch.Tensor:
    """Dictionary-path render of B walks (see
    BinauralDynamicRendering._ensure_dict_consts): (B, K, hop) stimulus
    segments, (B, K, J) real atom weights and the (J, 2·F2·2) real view of
    the dictionary -> (B, K*hop, 2) crossfaded binaural output.

    The same output as :func:`binaural_einsum_program` (the irfft@nfft →
    zero-pad → rfft@nfft2 roundtrip is folded into the precomputed atoms,
    which is exact by linearity); the per-hop einsums become one real
    matrix product and the hot program keeps only the stimulus rfft and the
    output irfft.
    """
    b, k_hops, hop = segs.shape
    seg_len, nfft2 = _conv_len(hop, nfft)
    bf = torch.view_as_complex(
        (coef.reshape(b * k_hops, -1) @ dictionary).reshape(b, k_hops, 2, nfft2 // 2 + 1, 2)
    )  # (B, K, 2, F2) convolution-ready BRTF
    sf = torch.fft.rfft(segs, nfft2, dim=-1)  # (B, K, F2)
    seg_t = torch.fft.irfft(sf[:, :, None] * bf, nfft2, dim=-1)[..., :seg_len]
    return ola_tail(seg_t, ola)


class OLAConstants(NamedTuple):
    """:func:`ola_tail`'s constants on the device (:func:`ola_constants`)."""

    idx: torch.Tensor  # (K-1, hop) gather index of the crossfade tails
    f_in: torch.Tensor  # (hop,) sqrt fade-in
    f_out: torch.Tensor  # (hop,) sqrt fade-out


def ola_constants(k_hops: int, hop: int, seg_len: int, device: torch.device) -> OLAConstants:
    """The overlap-add's constants on ``device``: the (K-1, hop) gather
    index of each hop's crossfade tail, taken as the host loop takes it
    (from the segment AFTER its truncation to the output buffer, rows t_k ..
    t_k + hop), and the sqrt fade-in and fade-out of one hop."""
    tail_start = torch.tensor(
        [min(seg_len, (k_hops - k) * hop) - hop for k in range(max(k_hops - 1, 1))],
        dtype=torch.long)
    idx = (tail_start[:, None] + torch.arange(hop)[None, :])[: k_hops - 1]
    f_in = torch.as_tensor(fade_windows(hop, fade_out=False, uncorr_fade=True), dtype=torch.float32)
    f_out = torch.as_tensor(fade_windows(hop, fade_out=True, uncorr_fade=True), dtype=torch.float32)
    return OLAConstants(idx.to(device), f_in.to(device), f_out.to(device))


def ola_tail(seg_t: torch.Tensor, ola: OLAConstants) -> torch.Tensor:
    """Back half of the batched binaural programs: (B, K, 2, seg_len) hop
    segments -> (B, K*hop, 2). Sqrt crossfades (fade-in on each hop's head
    but the first, faded-out previous-hop tails taken after the host loop's
    end-truncation) and a stride-``hop`` overlap-add of slice-adds. Exactly
    reproduces the host loop (reference sound_examples.py:430-539)."""
    idx, f_in, f_out = ola
    b, k_hops, ears, seg_len = seg_t.shape
    hop = f_in.shape[0]
    n_chunks = -(-seg_len // hop)
    head = seg_t[..., :hop]
    if k_hops > 1:
        tails = torch.gather(seg_t[:, : k_hops - 1], 3,
                             idx[None, :, None, :].expand(b, k_hops - 1, ears, hop))
        head = torch.cat([head[:, :1], head[:, 1:] * f_in], dim=1)
    seg_t2 = torch.cat([head, seg_t[..., hop:]], dim=-1)
    chunks = F.pad(seg_t2, (0, n_chunks * hop - seg_len)).reshape(
        b, k_hops, ears, n_chunks, hop)
    out = seg_t.new_zeros((b, ears, (k_hops + n_chunks) * hop))
    for m in range(n_chunks):
        out[..., m * hop:(m + k_hops) * hop] += (
            chunks[:, :, :, m].transpose(1, 2).reshape(b, ears, k_hops * hop))
    if k_hops > 1:
        out[..., hop:k_hops * hop] += (
            (tails * f_out).transpose(1, 2).reshape(b, ears, (k_hops - 1) * hop))
    return out[..., : k_hops * hop].transpose(1, 2)
