"""GFDN training losses against precomputed targets (port of ``losses/gfdn.py``).

The trainer precomputes the parameter-independent target EDC and EDR once
per dataset; these losses compare the model's RIRs with them. The random EDC
time mask is an explicit tensor, or drawn from a ``torch.Generator``
(probabilities ~ U(0, 1), then Bernoulli): ``jax.random`` bits cannot be
reproduced, so tests hand both packages the same mask.

Not ported yet (neither slice preset sets them; each raises in the trainer):
the aliasing regularizer ``reg_loss``, ``frequency_weighting`` and the ERB
grouping of the EDR (ROADMAP A5).
"""

from typing import Optional

import torch

from ..ops.basic import db, schroeder_backward_int
from ..ops.stft import edr_from_stft, stft


def edc_mask(
    length: int, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """Random EDC time mask (length,) of 0/1 float32: Bernoulli(U(0, 1))."""
    probs = torch.rand(length, generator=generator, device=device)
    return torch.bernoulli(probs, generator=generator)


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
) -> torch.Tensor:
    """Normalized |dB| EDR difference against the precomputed target EDR.

    ``target_edr_db`` (B, F, frames) and its |.| sum (B,): the per-item sum of
    |target - achieved| over frequency and time, divided by the item's sum,
    summed over the batch; unbatched inputs give the single ratio.
    """
    ach_edr = edr_from_stft(stft(achieved_rir, win_size, hop_size))
    freq_loss = torch.sum(torch.abs(target_edr_db - ach_edr), dim=-1)
    if target_edr_db.dim() == 3:
        return torch.sum(torch.sum(freq_loss, dim=-1) / target_edr_abs_sum)
    return torch.sum(freq_loss) / target_edr_abs_sum
