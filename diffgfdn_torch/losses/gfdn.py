"""GFDN training losses (port of ``losses/gfdn.py``).

The grid trainer precomputes the parameter-independent target EDC and EDR
once per dataset; :func:`edc_loss_from_rir` and :func:`edr_loss_from_rir`
compare the model's RIRs with them. A single-position fit compares raw
spectra, the target's and the model's, each step (:func:`edc_loss`,
:func:`edr_loss`). The directional EDC loss compares a directional model's
beamformed EDCs with the common-slope amplitudes times decay envelopes. The
random EDC time mask is an explicit tensor, or drawn from a
``torch.Generator`` (probabilities ~ U(0, 1), then Bernoulli): ``jax.random``
bits cannot be reproduced, so tests hand both packages the same mask.

The EDR losses take optional ERB grouping (``erb_filters`` (bands, bins) of
``ops/stft.erb_filterbank``, summing |STFT| per band) and frequency weights
(:func:`frequency_weighting`, on the EDR's frequency axis). The per-band EDC
of ``edc_loss(band_responses=...)`` compares linear EDCs and ignores the
mask, as the JAX package's does. :func:`reg_loss`, the aliasing regularizer
of the SVF output heads, evaluates their cascades through the cascade kernel
(``kernels/sos.py``: B3 forward, B4 backward on CUDA tensors).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.sos import sos_cascade_response
from ..ops.basic import db, schroeder_backward_int
from ..ops.stft import edr_from_stft, stft


def edc_mask(
    length: int, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """Random EDC time mask (length,) of 0/1 float32: Bernoulli(U(0, 1))."""
    probs = torch.rand(length, generator=generator, device=device)
    return torch.bernoulli(probs, generator=generator)


def scaled_shifted_sigmoid_inverse(
    x: torch.Tensor, scale_factor: float, cutoff: float, top: float, bottom: float
) -> torch.Tensor:
    """Reverse sigmoid from ``top`` down to ``bottom``, switching at ``cutoff``."""
    return bottom + (top - bottom) / (1.0 + torch.exp(scale_factor * (x - cutoff)))


def frequency_weighting(
    freqs_hz: np.ndarray,
    cutoff_freq_hz: float = 1e3,
    scale_factor: float = 10 ** (-2.5),
    top: float = 2.0,
    bottom: float = 1.0,
) -> torch.Tensor:
    """Low-frequency-emphasis weights of the EDR loss, float32 (F,): ``top``
    below ``cutoff_freq_hz``, falling to ``bottom`` above it. This is the
    documented intent; the reference's call site swaps top and bottom, so
    that its weights rise with frequency (``DESIGN.md``), and the JAX
    package implements the intent too."""
    return scaled_shifted_sigmoid_inverse(
        torch.as_tensor(np.asarray(freqs_hz), dtype=torch.float32), scale_factor,
        cutoff_freq_hz, top, bottom)


def _edr_features(s: torch.Tensor, erb_filters: Optional[torch.Tensor]) -> torch.Tensor:
    """EDR (dB) of an STFT (..., bins, frames), its |.| first summed into the
    ERB bands when ``erb_filters`` (bands, bins) are given."""
    if erb_filters is not None:
        s = torch.matmul(erb_filters, torch.abs(s))
    return edr_from_stft(s)


def edc_loss(
    target_response: torch.Tensor,
    achieved_response: torch.Tensor,
    mixing_time_samps: int,
    max_ir_len_samps: int,
    mask: Optional[torch.Tensor] = None,
    band_responses: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean |dB| difference between the Schroeder EDCs of two spectra (..., F),
    both irfft'd and cut to [mixing time, max length]; ``mask`` as in
    :func:`edc_loss_from_rir`.

    ``band_responses`` (bands, F) complex: the sum over the bands of the mean
    |EDC difference| of both spectra times the band's response, in LINEAR
    scale and with ``mask`` ignored, as the JAX package's subband branch is.
    """
    n = 2 * (target_response.shape[-1] - 1)
    end = min(max_ir_len_samps, n)
    if band_responses is not None:
        total = torch.zeros((), dtype=torch.float32, device=target_response.device)
        for resp in band_responses:
            t_rir = torch.fft.irfft(target_response * resp, n, dim=-1)[..., mixing_time_samps:end]
            a_rir = torch.fft.irfft(achieved_response * resp, n, dim=-1)[
                ..., mixing_time_samps:end]
            total = total + torch.mean(torch.abs(
                schroeder_backward_int(t_rir) - schroeder_backward_int(a_rir)))
        return total
    target_rir = torch.fft.irfft(target_response, n, dim=-1)[..., mixing_time_samps:end]
    target_edc = db(schroeder_backward_int(target_rir), is_squared=True)
    achieved_rir = torch.fft.irfft(achieved_response, n, dim=-1)[..., mixing_time_samps:end]
    return edc_loss_from_rir(target_edc, achieved_rir, mask)


def edr_loss(
    target_response: torch.Tensor,
    achieved_response: torch.Tensor,
    win_size: int = 2 ** 12,
    hop_size: int = 2 ** 11,
    reduced_pole_radius: Optional[float] = None,
    erb_filters: Optional[torch.Tensor] = None,
    frequency_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Normalized |dB| EDR difference between two spectra (..., F): both
    irfft'd, the achieved RIR's reduced-pole-radius envelope undone, then as
    :func:`edr_loss_from_rir` against the target's EDR."""
    n = 2 * (target_response.shape[-1] - 1)
    target_rir = torch.fft.irfft(target_response, n, dim=-1)
    achieved_rir = torch.fft.irfft(achieved_response, n, dim=-1)
    if reduced_pole_radius is not None and reduced_pole_radius != 1.0:
        achieved_rir = achieved_rir * torch.pow(
            1.0 / reduced_pole_radius,
            torch.arange(n, dtype=torch.float32, device=achieved_rir.device),
        )
    target_edr = _edr_features(stft(target_rir, win_size, hop_size), erb_filters)
    return edr_loss_from_rir(target_edr, torch.sum(torch.abs(target_edr), dim=(-2, -1)),
                             achieved_rir, win_size, hop_size, erb_filters, frequency_weights)


def edc_loss_from_rir(
    target_edc_db: torch.Tensor,
    achieved_rir_trunc: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean |dB| difference between the target EDC and the achieved RIR's EDC.

    ``achieved_rir_trunc``: (..., T) RIRs already cut to [mixing time, max
    length]; ``mask``: optional (T,) 0/1 time mask, the loss then being
    sum(err * mask) / (sum(mask) * batch + 1e-9).
    """
    a_edc = schroeder_backward_int(achieved_rir_trunc)
    err = torch.abs(target_edc_db - db(a_edc, is_squared=True))
    if mask is None:
        return torch.mean(err)
    items = err.numel() // err.shape[-1]
    return torch.sum(err * mask) / (torch.sum(mask) * items + 1e-9)


def edr_loss_from_rir(
    target_edr_db: torch.Tensor,
    target_edr_abs_sum: torch.Tensor,
    achieved_rir: torch.Tensor,
    win_size: int = 2 ** 12,
    hop_size: int = 2 ** 11,
    erb_filters: Optional[torch.Tensor] = None,
    frequency_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Normalized |dB| EDR difference against the precomputed target EDR.

    ``target_edr_db`` (B, F, frames) and its |.| sum (B,): the per-item sum of
    |target - achieved| over frequency and time, divided by the item's sum,
    summed over the batch; unbatched inputs give the single ratio. With
    ``erb_filters`` F is the ERB bands (the target grouped alike);
    ``frequency_weights`` (F,) weight each frequency's sum over time.
    """
    ach_edr = _edr_features(stft(achieved_rir, win_size, hop_size), erb_filters)
    freq_loss = torch.sum(torch.abs(target_edr_db - ach_edr), dim=-1)
    if frequency_weights is not None:
        freq_loss = freq_loss * frequency_weights
    if target_edr_db.dim() == 3:
        return torch.sum(torch.sum(freq_loss, dim=-1) / target_edr_abs_sum)
    return torch.sum(freq_loss) / target_edr_abs_sum


_reg_points: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _unit_circle(num_bins: int, device: torch.device) -> torch.Tensor:
    """exp(1j w) at ``num_bins`` points w evenly over [0, pi], complex64, made
    once per size and device: a step captured in a CUDA graph copies nothing
    from the host."""
    key = (num_bins, device)
    if key not in _reg_points:
        w = torch.linspace(0.0, np.pi, num_bins, dtype=torch.float32, device=device)
        _reg_points[key] = torch.exp(1j * w).to(torch.complex64)
    return _reg_points[key]


def reg_loss(biquad_num: torch.Tensor, biquad_den: torch.Tensor,
             num_time_samps: int) -> torch.Tensor:
    """Time-aliasing regularizer on the output filters' decay.

    ``biquad_num`` / ``biquad_den``: (B, G, K, 3) cascades. Each cascade's
    impulse response is the irfft of its response on a ``num_time_samps``
    grid (the cascade kernel); per item the late / early |h| ratio of each
    group (the last and first eighths), softmax-weighted over the groups,
    summed over the batch.
    """
    nfft = num_time_samps
    z = _unit_circle(nfft // 2 + 1, biquad_num.device)
    h = torch.fft.irfft(sos_cascade_response(biquad_num, biquad_den, z), nfft, dim=-1)
    n0 = int(round(num_time_samps / 8))
    early = torch.sum(torch.abs(h[..., :n0]), dim=-1)
    late = torch.sum(torch.abs(h[..., num_time_samps - n0:]), dim=-1)
    gamma = late / (early + 1e-12)  # (B, G)
    weights = torch.softmax(gamma, dim=-1)
    return torch.sum(weights * gamma)


def _directional_edc_from_rir(
    pred_rir: torch.Tensor,
    amps_true: torch.Tensor,
    envelopes: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean |dB| error between the Schroeder EDCs of directional RIRs
    (B, J, T) and the envelopes (num_slopes, >= T) weighted by the
    common-slope amplitudes (B, J, num_slopes); ``mask`` as in
    :func:`edc_loss_from_rir`."""
    edc_pred = schroeder_backward_int(pred_rir)
    t = edc_pred.shape[-1]
    edc_true = torch.matmul(amps_true.to(torch.float32), envelopes[:, :t])
    err = torch.abs(db(edc_true, is_squared=True) - db(edc_pred, is_squared=True))
    if mask is None:
        return torch.mean(err)
    items = err.numel() // err.shape[-1]
    return torch.sum(err * mask) / (torch.sum(mask) * items + 1e-9)


def directional_edc_loss(
    h_pred: torch.Tensor,
    amps_true: torch.Tensor,
    envelopes: torch.Tensor,
    mixing_time_samps: int,
    edc_len_samps: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EDC error of directional transfer functions (B, J, F) from sample
    ``mixing_time_samps`` on, ``edc_len_samps`` long."""
    n = 2 * (h_pred.shape[-1] - 1)
    pred_rir = torch.fft.irfft(h_pred, n, dim=-1)[
        ..., mixing_time_samps:edc_len_samps + mixing_time_samps
    ]
    return _directional_edc_from_rir(pred_rir, amps_true, envelopes, mask)


def directional_edc_loss_from_sh(
    h_sh: torch.Tensor,
    analysis_matrix: torch.Tensor,
    amps_true: torch.Tensor,
    envelopes: torch.Tensor,
    mixing_time_samps: int,
    edc_len_samps: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The same loss fed the SH-domain response (B, L, F): the L SH channels
    are irfft'd, cut to the window, and beamformed to the J directions by the
    analysis matrix (J, L) as a real product (the matrix commutes with the
    irfft), so no (B, J, F) complex intermediate is made."""
    n = 2 * (h_sh.shape[-1] - 1)
    hi = min(edc_len_samps + mixing_time_samps, n)
    rir_sh = torch.fft.irfft(h_sh, n, dim=-1)[..., mixing_time_samps:hi]
    pred_rir = torch.matmul(analysis_matrix.to(torch.float32), rir_sh)  # (B, J, T)
    return _directional_edc_from_rir(pred_rir, amps_true, envelopes, mask)
