"""Common-slopes RIR synthesis on the device: multiband shaped noise -> SRIRs.

Port of ``diffgfdn_tpu/inference/cs_synthesis.py``, on tensors:

* :func:`draw_noise` draws white noise from an explicit ``torch.Generator``
  and :func:`filter_band_noise` filters it into octave bands (an rfft
  convolution, then the filterbank's group delay trimmed);
* :func:`shaped_wgn_multiband` scales each band's noise by the square root
  of its CS energy envelope and sums the bands;
* :func:`spatial_bandlimiting` (Hold et al., or the covariance-preserving
  "custom" method) and :func:`convert_directional_rirs_to_ambisonics` (the
  synthesis spherical filterbank);
* :func:`get_rirs_from_common_slopes_model`, CS amplitudes -> omni or
  ambisonic RIRs; :func:`calculate_energy_envelope`.

The filterbank and SH matrices are designed on the host (``ops/``) in float64
and applied on the device in float32. The noise is the port's own: a
``torch.Generator`` seeded with ``seed`` draws one tensor for every
direction, where the JAX package draws direction j from ``fold_in(key, j)``.
For a seed the two packages give different noise, so different RIRs with the
same envelopes; given the same noise (the ``noise`` arguments) they agree.
"""

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.schema import BeamformerType
from ..ops.basic import LOG10E6
from ..ops.filterbanks import reconstructing_fractional_octave_bands
from ..ops.sph import design_sph_filterbank, modal_weights, repeat_per_order, sh_matrix

FIR_LEN = 2 ** 12


def draw_noise(shape: Tuple[int, ...], generator: torch.Generator,
               device: Union[str, torch.device]) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` on ``device`` (the
    generator must live on that device)."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def filter_band_noise(noise: torch.Tensor, band_filters: torch.Tensor) -> torch.Tensor:
    """(..., num_bands, n) noise filtered by the (num_bands, L) band filters.

    The linear convolution is an rfft product at nfft = the next power of
    two >= n + L - 1; the output keeps n samples after the filterbank's
    linear-phase group delay L // 2.
    """
    n = noise.shape[-1]
    filt_len = band_filters.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + filt_len - 1)))
    spec = torch.fft.rfft(noise, nfft, dim=-1) * torch.fft.rfft(band_filters, nfft, dim=-1)
    out = torch.fft.irfft(spec, nfft, dim=-1)
    delay = filt_len // 2
    return out[..., delay:delay + n]


def octave_band_filters(f_bands: Sequence[float], sample_rate: float,
                        fir_len: int = FIR_LEN) -> np.ndarray:
    """(len(f_bands), fir_len) filters of the amplitude-preserving octave
    bank nearest each requested centre frequency (host float64)."""
    filters, centers = reconstructing_fractional_octave_bands(
        num_fractions=1, frequency_range=(min(f_bands), max(f_bands)), n_samples=fir_len,
        sampling_rate=sample_rate,
    )
    return filters[[int(np.argmin(np.abs(centers - fc))) for fc in f_bands]]


def shaped_wgn_multiband(
    decay_times: np.ndarray,
    amplitudes: torch.Tensor,
    sample_rate: float,
    n_samples: int,
    f_bands: List[float],
    noise: torch.Tensor,
    fir_len: int = FIR_LEN,
) -> torch.Tensor:
    """Common-slopes RIRs as octave-band shaped white noise, (num_pos, n_samples).

    ``decay_times``: (num_slopes,) broadband or (num_slopes, num_bands);
    ``amplitudes``: (num_pos, num_slopes, num_bands) on the device;
    ``noise``: (num_pos, num_bands, n_samples) white noise on the same device
    (:func:`draw_noise`). The sum over bands of band-filtered noise times
    sqrt(the band's CS energy envelope).
    """
    device = amplitudes.device
    amplitudes = amplitudes.to(torch.float32)
    num_bands = amplitudes.shape[-1]
    decay_times = np.asarray(decay_times, np.float32)
    if decay_times.ndim == 1:
        decay_times = np.repeat(decay_times[:, None], num_bands, axis=1)
    filters = torch.as_tensor(octave_band_filters(f_bands, sample_rate, fir_len),
                              dtype=torch.float32, device=device)

    t = torch.arange(n_samples, dtype=torch.float32, device=device) / sample_rate
    rate = torch.as_tensor(LOG10E6 / decay_times.T, device=device)  # (num_bands, num_slopes)
    env_kernel = torch.exp(-t[None, None, :] * rate[:, :, None])  # (B, S, T)
    env = torch.clamp(torch.einsum("pkb,bkt->pbt", amplitudes, env_kernel), min=0.0)
    return torch.sum(filter_band_noise(noise, filters) * torch.sqrt(env), dim=-2)


def spatial_bandlimiting(
    ambi_order: int,
    des_dir: np.ndarray,
    drirs: torch.Tensor,
    modal_weights_n: np.ndarray,
    method: str = "custom",
) -> torch.Tensor:
    """Spatially band-limit directional RIRs (J, num_pos, T).

    ``des_dir``: (2, J) (azimuth, elevation). "Hold" mixes the directions by
    the row-normalized covariance of the beam patterns; "custom" mixes them
    by the covariance itself, scaled per position so the total energy is
    kept.
    """
    y = sh_matrix(ambi_order, des_dir[0, :], np.pi / 2 - des_dir[1, :])
    des_cov = y @ np.diag(repeat_per_order(modal_weights_n)) @ y.T  # (J, J)
    if method == "Hold":
        mult = torch.as_tensor(des_cov / np.sum(des_cov, axis=1, keepdims=True),
                               dtype=drirs.dtype, device=drirs.device)
        return torch.einsum("jk,krt->jrt", mult, drirs)
    cov = torch.as_tensor(des_cov, dtype=drirs.dtype, device=drirs.device)
    est_cov = torch.einsum("jrt,krt->rjk", drirs, drirs) / drirs.shape[-1]  # (P, J, J)
    denom = cov @ est_cov @ cov.T
    norm = torch.sqrt(torch.diagonal(est_cov, dim1=-2, dim2=-1).sum(-1)
                      / torch.diagonal(denom, dim1=-2, dim2=-1).sum(-1))  # (P,)
    return torch.einsum("jk,krt->jrt", cov, drirs) * norm[None, :, None]


def convert_directional_rirs_to_ambisonics(
    ambi_order: int,
    desired_directions: np.ndarray,
    beamformer_type: Optional[BeamformerType],
    directional_rirs: torch.Tensor,
    apply_spatial_bandlimiting: bool = False,
    bandlimit_method: str = "custom",
) -> torch.Tensor:
    """Directional RIRs (J, num_pos, T) -> ambisonic RIRs (num_pos, (N+1)^2, T)
    through the synthesis filterbank."""
    c_n = modal_weights(beamformer_type, ambi_order)
    drirs = directional_rirs
    if apply_spatial_bandlimiting:
        drirs = spatial_bandlimiting(ambi_order, desired_directions, drirs, c_n,
                                     bandlimit_method)
    _, synthesis = design_sph_filterbank(
        ambi_order, desired_directions[0, :], np.pi / 2 - desired_directions[1, :], c_n,
        mode="energy",
    )
    synthesis = torch.as_tensor(synthesis, dtype=drirs.dtype, device=drirs.device)  # (J, Q)
    return torch.einsum("jn,jbt->bnt", synthesis, drirs)


def get_rirs_from_common_slopes_model(
    sample_rate: float,
    rec_pos_list: np.ndarray,
    freq_bands: List[float],
    ir_len_samps: int,
    amplitudes: torch.Tensor,
    common_decay_times: np.ndarray,
    ambi_order: Optional[int] = None,
    des_directions: Optional[np.ndarray] = None,
    beamformer_type: Optional[BeamformerType] = None,
    apply_spatial_bandlimiting: bool = False,
    seed: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CS amplitudes -> omni (num_pos, T) or ambisonic (num_pos, (N+1)^2, T) RIRs.

    ``amplitudes``: (num_pos, num_slopes, num_bands) omni or
    (num_pos, num_directions, num_slopes, num_bands) directional, on the
    device the synthesis runs on. ``common_decay_times``: (num_slopes,)
    broadband, or 2-D in the dataset layout (num_bands, num_slopes) (the
    square case is read as that layout) or its transpose. ``noise``: white
    noise of shape (num_pos, num_bands, T) omni or (num_directions, num_pos,
    num_bands, T) directional; else one draw from a generator seeded with
    ``seed`` on the amplitudes' device.
    """
    device = amplitudes.device
    cdt = np.asarray(common_decay_times)
    nb, ns = len(freq_bands), amplitudes.shape[-2]
    if cdt.ndim == 1:
        cdt_slopes = cdt
    elif cdt.shape == (nb, ns):
        cdt_slopes = cdt.T
    elif cdt.shape == (ns, nb):
        cdt_slopes = cdt
    else:
        raise ValueError(
            f"common_decay_times shape {cdt.shape} matches neither "
            f"(num_bands={nb}, num_slopes={ns}) nor its transpose"
        )
    if noise is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        shape = (len(rec_pos_list), nb, ir_len_samps)
        if ambi_order is not None:
            shape = (des_directions.shape[-1],) + shape
        noise = draw_noise(shape, generator, device)

    if ambi_order is not None:
        num_dirs, num_pos = des_directions.shape[-1], len(rec_pos_list)
        amps = amplitudes.transpose(0, 1).reshape(num_dirs * num_pos, ns, nb)
        drirs = shaped_wgn_multiband(
            cdt_slopes, amps, sample_rate, ir_len_samps, freq_bands,
            noise=noise.reshape(num_dirs * num_pos, nb, ir_len_samps),
        ).reshape(num_dirs, num_pos, ir_len_samps)
        return convert_directional_rirs_to_ambisonics(
            ambi_order, des_directions, beamformer_type, drirs,
            apply_spatial_bandlimiting=apply_spatial_bandlimiting,
        )
    return shaped_wgn_multiband(cdt_slopes, amplitudes, sample_rate, ir_len_samps, freq_bands,
                                noise=noise)


def calculate_energy_envelope(signal: torch.Tensor, sample_rate: float,
                              win_len_ms: float = 20.0) -> torch.Tensor:
    """Short-time mean-square envelope along the last axis: x^2 convolved with
    a unit-sum Hann window, centred ("same" length), as an rfft product."""
    wl = max(int(win_len_ms * 1e-3 * sample_rate), 2)
    win = np.hanning(wl)
    win = torch.as_tensor(win / win.sum(), dtype=signal.dtype, device=signal.device)
    n = signal.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + wl - 1)))
    full = torch.fft.irfft(torch.fft.rfft(signal ** 2, nfft, dim=-1)
                           * torch.fft.rfft(win, nfft, dim=-1), nfft, dim=-1)
    start = (wl - 1) // 2
    return full[..., start:start + n]
