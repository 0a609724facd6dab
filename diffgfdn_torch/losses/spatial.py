"""Common-slopes spatial-sampling losses (port of ``diffgfdn_tpu/losses/spatial.py``).

The amplitude losses (dB error of the amplitudes, or of the decay envelopes
they weight), the RBF smoothness kernel over receiver pairs (host numpy,
once per dataset) and the smoothness loss of the beamforming weights.
:func:`make_decay_envelopes` is also what the directional FDN's EDC loss
weights by the common-slope amplitudes.
"""

import numpy as np
import torch

from ..ops.basic import db, decay_kernel


def spatial_mse_loss(amps_pred: torch.Tensor, amps_true: torch.Tensor) -> torch.Tensor:
    """Mean |dB| error between predicted and true amplitudes, summed over slopes."""
    return torch.sum(torch.mean(torch.abs(db(amps_pred) - db(amps_true)), dim=0))


def make_decay_envelopes(
    common_decay_times: np.ndarray, edc_len_samps: int, fs: float
) -> torch.Tensor:
    """(num_slopes, T) unit-norm decay kernels, float32, on the host."""
    t_axis = np.arange(edc_len_samps) / fs
    env = decay_kernel(np.asarray(common_decay_times).reshape(-1), t_axis,
                       normalize_envelope=True)
    return torch.from_numpy(np.ascontiguousarray(env.T, dtype=np.float32))


def spatial_edc_loss(
    amps_pred: torch.Tensor, amps_true: torch.Tensor, envelopes: torch.Tensor
) -> torch.Tensor:
    """EDC error between amplitude-weighted decay envelopes, in dB.

    Omni amplitudes (B, num_slopes): each slope's envelope compared alone,
    averaged over batch and time, summed over slopes. Directional
    (B, J, num_slopes): the slopes summed first, then the mean |dB| error.
    """
    if amps_true.ndim == 2:
        edc_true = db(torch.einsum("bk,kt->bkt", amps_true, envelopes), is_squared=True)
        edc_pred = db(torch.einsum("bk,kt->bkt", amps_pred, envelopes), is_squared=True)
        return torch.sum(torch.mean(torch.abs(edc_true - edc_pred), dim=(0, -1)))
    edc_true = db(torch.einsum("bjk,kt->bjt", amps_true, envelopes), is_squared=True)
    edc_pred = db(torch.einsum("bjk,kt->bjt", amps_pred, envelopes), is_squared=True)
    return torch.mean(torch.abs(edc_true - edc_pred))


def make_smoothness_kernel(all_receiver_pos: np.ndarray) -> np.ndarray:
    """Row-normalized RBF affinity over receiver pairs (sigma = 1/sqrt(2)), host float32."""
    pos = np.asarray(all_receiver_pos, np.float64)
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    sigma = 1.0 / np.sqrt(2.0)
    k = np.exp(-(d ** 2) / (2.0 * sigma ** 2))
    k = k / (k.sum(axis=1, keepdims=True) + 1e-10)
    return k.astype(np.float32)


def find_position_idx(all_receiver_pos: torch.Tensor, cur_positions: torch.Tensor) -> torch.Tensor:
    """Index of each batch position in the full receiver list (nearest match)."""
    d2 = torch.sum((all_receiver_pos[None, :, :] - cur_positions[:, None, :]) ** 2, dim=-1)
    return torch.argmin(d2, dim=1)


def spatial_smoothness_loss(
    kernel_weights: torch.Tensor, pos_idx: torch.Tensor, cur_weights: torch.Tensor
) -> torch.Tensor:
    """NEGATIVE kernel-weighted pairwise weight distance (encourages variation).

    ``kernel_weights``: the full (M, M) affinity; ``pos_idx``: (B,) dataset
    indices of the batch positions; ``cur_weights``: (B, num_slopes, D)
    beamforming weights.

    The squared distances are sums of squared differences, so a vector's
    distance to itself is 0 (the floor 1e-12 applies). The JAX package
    expands them as |a|^2 + |b|^2 - 2 a.b, which leaves float32 rounding of
    |w|^2 on the diagonal, some 1e-3 after the square root (ROADMAP C13);
    the two agree where that rounding vanishes, in float64.
    """
    kw = kernel_weights[pos_idx][:, pos_idx]  # (B, B)
    w = cur_weights.permute(1, 0, 2)  # (num_slopes, B, D)
    d2 = torch.sum((w[:, :, None, :] - w[:, None, :, :]) ** 2, dim=-1)
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    return -torch.sum(torch.einsum("kbp,bp->k", dist, kw))
