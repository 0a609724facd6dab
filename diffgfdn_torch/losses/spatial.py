"""Common-slopes spatial-sampling losses (port of ``diffgfdn_tpu/losses/spatial.py``).

The amplitude losses (dB error of the amplitudes, or of the decay envelopes
they weight), the RBF smoothness kernel over receiver pairs (host numpy,
once per dataset) and the smoothness loss of the beamforming weights.
:func:`make_decay_envelopes` is also what the directional FDN's EDC loss
weights by the common-slope amplitudes.

The directional EDC loss runs over (B, J, T) envelopes: at the floor-plan
CNN's full 0.3 m grid (B = 2745 cells, J = 12, T = 70400) one such tensor is
9.3 GB, and autograd would keep four of them. So its forward runs in chunks
of receivers and keeps one (B, J, T) tensor, the derivative of each
element's error, for a backward that is one contraction
(:class:`_DirectionalEDCError`).
"""

import math

import numpy as np
import torch

from ..ops.basic import _EPS_F32, db, decay_kernel

CHUNK_ELEMENTS = 2 ** 27  # envelope elements a chunk of the directional EDC loss holds


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
    (B, J, num_slopes): the slopes summed first, then the mean |dB| error,
    computed as many receivers at a time as fill ``CHUNK_ELEMENTS``; the
    targets take no gradient.
    """
    if amps_true.ndim == 2:
        edc_true = db(torch.einsum("bk,kt->bkt", amps_true, envelopes), is_squared=True)
        edc_pred = db(torch.einsum("bk,kt->bkt", amps_pred, envelopes), is_squared=True)
        return torch.sum(torch.mean(torch.abs(edc_true - edc_pred), dim=(0, -1)))
    if amps_true.requires_grad:
        raise ValueError("the directional EDC loss takes no gradient for its targets")
    b, j, _ = amps_pred.shape
    t = envelopes.shape[-1]
    rows = max(1, CHUNK_ELEMENTS // (j * t))
    with_slope = torch.is_grad_enabled() and amps_pred.requires_grad
    return _DirectionalEDCError.apply(amps_pred, amps_true, envelopes, rows,
                                      with_slope) / (b * j * t)


class _DirectionalEDCError(torch.autograd.Function):
    """The sum over (B, J, T) of |db(E_true) - db(E_pred)|, E = amps @ envelopes,
    in chunks of ``rows`` receivers.

    ``db``'s clip at -200 dB never binds here: |E| + eps >= eps puts every
    level at or above -69.2 dB. So the error is 10 |log10 m_t - log10 m_p|,
    m = |E| + eps, and its derivative in E_pred is
    sign(diff) sign(E_pred) / m_p times -10 / ln 10, as autograd takes it
    (abs takes sign(x)). With ``with_slope`` (amps_pred takes a gradient) each
    chunk writes sign(diff) sign(E_pred) / m_p into one (B, J, T) tensor,
    which backward contracts with the envelopes.
    """

    @staticmethod
    def forward(ctx, amps_pred, amps_true, envelopes, rows, with_slope):
        b, j, _ = amps_pred.shape
        slope = amps_pred.new_empty((b, j, envelopes.shape[-1])) if with_slope else None
        total = amps_pred.new_zeros(())
        for s in range(0, b, rows):
            e = torch.einsum("bjk,kt->bjt", amps_pred[s:s + rows], envelopes)
            mag = torch.abs(e).add_(_EPS_F32)
            diff = torch.einsum("bjk,kt->bjt", amps_true[s:s + rows], envelopes)
            diff = diff.abs_().add_(_EPS_F32).log10_().sub_(torch.log10(mag))
            total = total + torch.sum(torch.abs(diff))
            if slope is not None:
                torch.mul(torch.sign(diff), torch.sign(e), out=slope[s:s + rows])
                slope[s:s + rows].div_(mag)
        ctx.save_for_backward(slope, envelopes)
        return 10.0 * total

    @staticmethod
    def backward(ctx, grad):
        slope, envelopes = ctx.saved_tensors
        scale = grad * (-10.0 / math.log(10.0))
        return torch.einsum("bjt,kt->bjk", slope, envelopes) * scale, None, None, None, None


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
