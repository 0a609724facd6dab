"""Colorless (lossless-prototype) FDN (port of ``models/colorless.py``).

One group of delay lines with a dense orthogonal feedback matrix (RANDOM
coupling: exp(skew(X))) and a nominal broadband T60 of 10 s, trained so that
|H| ~ 1 at every bin (``training/colorless_trainer.py``). Its optimized io
gains and feedback matrix warm-start one group of a DiffGFDN
(``training/build.py colorless_to_init``).
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import CouplingMatrixType
from .feedback_loop import FeedbackLoop
from .gfdn import _io_gains


class ColorlessFDN(nn.Module):
    """Lossless prototype FDN of one group: parameters ``input_gains``,
    ``output_gains`` (N, 1) and ``feedback_loop.random_feedback_matrix`` (N, N)."""

    def __init__(
        self,
        sample_rate: float,
        delays: Sequence[int],
        nominal_t60: float = 10.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.sample_rate = sample_rate
        self.delays = tuple(int(d) for d in delays)
        self.num_delay_lines = n = len(self.delays)
        self.input_gains = _io_gains(n, generator)
        self.output_gains = _io_gains(n, generator)
        gains = 10.0 ** (-3.0 * np.asarray(self.delays, np.float64) / (sample_rate * nominal_t60))
        self.feedback_loop = FeedbackLoop(
            num_groups=1, num_delay_lines_per_group=n, delays=self.delays,
            coupling_matrix_type=CouplingMatrixType.RANDOM, gains=gains, generator=generator,
        )

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(H (F,), H per delay line (N, F)) at z on the unit circle, through
        the dense (F, N, N) inverse of the loop (the Gauss-Jordan kernel)."""
        p = self.feedback_loop(z)  # (F, N, N)
        c = self.output_gains[:, 0].to(torch.complex64)
        b = self.input_gains[:, 0].to(torch.complex64)
        h_per_del = c[:, None] * torch.einsum("fnm,m->nf", p, b)
        return h_per_del.sum(dim=0), h_per_del

    def feedback_matrix(self) -> torch.Tensor:
        """The orthogonal feedback matrix exp(skew(X)), (N, N)."""
        return self.feedback_loop.coupled_feedback_matrix()
