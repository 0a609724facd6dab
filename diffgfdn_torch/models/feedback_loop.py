"""GFDN feedback loop: P(z) = (D(z) Gamma(z)^-1 - A(z))^-1 at all rFFT bins.

Port of ``diffgfdn_tpu/models/feedback_loop.py``. Coupling: SCALAR (zero
coupling, or learned Givens angles), FILTER (the group-level coupling is an
FIR paraunitary polynomial matrix, so A(z) is a polynomial in z^-1 and the
loop is dense) and RANDOM (one dense orthogonal matrix exp(skew(X)), as the
colorless prototype FDN uses). The per-bin inverse and solve go through
``kernels/linalg.py`` (Gauss-Jordan and LU kernels), the SOS absorption
cascades through the biquad-cascade kernel.

Absorption: fixed per-line scalar gains (``gains``), learnable common decay
times per group (``learn_common_decay_times``), fixed per-line SOS cascades
fitted by the GEQ designer (``sos_coeffs``) or fixed per-line IIR filters
fitted by warped Prony (``iir_coeffs``).
"""

import contextlib
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config.schema import CouplingMatrixType
from ..kernels.linalg import cinv, csolve1
from ..kernels.sos import sos_cascade_response
from ..ops.absorption import decay_times_to_gain_per_sample
from ..ops.biquad import iir_frequency_response
from ..ops.unitary import (
    fir_paraunitary,
    nd_unitary,
    orthogonal_from_skew,
    paraunitary_frequency_response,
)


def _buffer(module: nn.Module, name: str, value: Optional[np.ndarray]) -> None:
    module.register_buffer(
        name, None if value is None else torch.as_tensor(np.asarray(value), dtype=torch.float32),
        persistent=False,
    )


class FeedbackLoop(nn.Module):
    """Coupled feedback loop of the grouped FDN.

    ``delays``: per-line lengths in samples (N). Absorption, exactly one of:
    ``gains`` (N,) fixed per-line gains; ``sos_coeffs`` (N, n_sections, 3, 2)
    cascades or ``iir_coeffs`` (N, order + 1, 2) filters, (num, den) on the
    last axis; ``learn_common_decay_times``: a ``common_decay_times`` (G,)
    parameter, from ``common_decay_times_init`` or U(0.1, 2.0) s, whose
    per-line gains need the ``sample_rate``. Parameters, SCALAR and FILTER
    coupling: ``M`` (G, Nper, Nper) skew pre-images
    (``colorless_feedback_matrix_skew`` initializes it, the colorless
    prototypes' optima, :mod:`..training.build`); with learned SCALAR
    coupling ``alpha`` (G(G-1)/2 angles); with FILTER coupling
    ``unit_vectors`` (G, order - 1) and ``unitary_matrix`` (G, G), order
    ``coupling_matrix_order``. RANDOM coupling: ``random_feedback_matrix``
    (N, N), whose exp(skew(.)) is the whole loop's feedback matrix.
    """

    def __init__(
        self,
        num_groups: int,
        num_delay_lines_per_group: int,
        delays: Sequence[int],
        coupling_matrix_type: CouplingMatrixType = CouplingMatrixType.SCALAR,
        use_zero_coupling: bool = True,
        gains: Optional[np.ndarray] = None,
        sos_coeffs: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        colorless_feedback_matrix_skew: Optional[np.ndarray] = None,
        coupling_matrix_order: Optional[int] = None,
        iir_coeffs: Optional[np.ndarray] = None,
        learn_common_decay_times: bool = False,
        common_decay_times_init: Optional[Sequence[float]] = None,
        sample_rate: Optional[float] = None,
    ):
        super().__init__()
        self.coupling_matrix_type = CouplingMatrixType(coupling_matrix_type)
        given = sum(x is not None for x in (gains, sos_coeffs, iir_coeffs))
        if given + bool(learn_common_decay_times) != 1:
            raise ValueError("give exactly one of gains, sos_coeffs, iir_coeffs or "
                             "learn_common_decay_times")
        if learn_common_decay_times and sample_rate is None:
            raise ValueError("learnable common decay times need the sample_rate")
        self.num_groups = g = num_groups
        self.num_delay_lines_per_group = nper = num_delay_lines_per_group
        self.num_delays = len(delays)
        self.use_zero_coupling = use_zero_coupling
        self.sample_rate = sample_rate
        self.learn_common_decay_times = learn_common_decay_times
        _buffer(self, "delays", delays)
        _buffer(self, "gains", gains)
        _buffer(self, "sos_coeffs", sos_coeffs)
        _buffer(self, "iir_coeffs", iir_coeffs)
        # the designed filters as given (float64 from the GEQ / Prony fits):
        # the time-domain path builds its state-space constants from them
        self.sos_coeffs_host = None if sos_coeffs is None else np.asarray(sos_coeffs)
        self.iir_coeffs_host = None if iir_coeffs is None else np.asarray(iir_coeffs)
        self._shared_blocks = None
        if self.coupling_matrix_type is CouplingMatrixType.RANDOM:
            n = self.num_delays
            self.random_feedback_matrix = nn.Parameter(
                (2.0 * torch.rand((n, n), generator=generator) - 1.0) / np.sqrt(nper)
            )
        else:
            if colorless_feedback_matrix_skew is not None:
                self.M = nn.Parameter(torch.as_tensor(
                    np.asarray(colorless_feedback_matrix_skew), dtype=torch.float32).clone())
            else:
                self.M = nn.Parameter(
                    (2.0 * torch.rand((g, nper, nper), generator=generator) - 1.0)
                    / np.sqrt(nper)
                )
        if self.coupling_matrix_type is CouplingMatrixType.SCALAR:
            n_alpha = g * (g - 1) // 2
            if use_zero_coupling:
                self.register_buffer("alpha", torch.zeros(n_alpha), persistent=False)
            else:
                self.alpha = nn.Parameter(np.pi / 4 * torch.rand((n_alpha,), generator=generator))
        elif self.coupling_matrix_type is CouplingMatrixType.FILTER:
            if coupling_matrix_order is None or coupling_matrix_order < 1:
                raise ValueError("FILTER coupling needs a coupling_matrix_order >= 1")
            self.unit_vectors = nn.Parameter(
                torch.randn((g, coupling_matrix_order - 1), generator=generator))
            self.unitary_matrix = nn.Parameter(
                (2.0 * torch.rand((g, g), generator=generator) - 1.0) / np.sqrt(g))
        if learn_common_decay_times:
            if common_decay_times_init is not None:
                init = torch.as_tensor(np.asarray(common_decay_times_init),
                                       dtype=torch.float32).reshape(g).clone()
            else:
                init = 0.1 + 1.9 * torch.rand((g,), generator=generator)
            self.common_decay_times = nn.Parameter(init)

    # ------------------------------ absorption ------------------------------

    @property
    def use_absorption_filters(self) -> bool:
        return self.sos_coeffs is not None or self.iir_coeffs is not None

    def gamma_scalar(self) -> torch.Tensor:
        """Per-line scalar absorption gains, shape (N,): the fixed gains, or
        those of the learnable common decay times (differentiable in them)."""
        if self.learn_common_decay_times:
            delays = self.delays.reshape(self.num_groups, self.num_delay_lines_per_group)
            return decay_times_to_gain_per_sample(
                self.common_decay_times[:, None], delays, self.sample_rate).reshape(-1)
        return self.gains

    def gamma_response(self, z: torch.Tensor) -> torch.Tensor:
        """Per-line absorption filter responses, shape (N, F) complex64: the
        SOS cascades through the cascade kernel, or the IIR filters."""
        if self.sos_coeffs is not None:
            return sos_cascade_response(self.sos_coeffs[..., 0], self.sos_coeffs[..., 1], z)
        return iir_frequency_response(self.iir_coeffs[..., 0], self.iir_coeffs[..., 1], z)

    # ---------------------------- feedback matrix ---------------------------

    def orthogonal_blocks(self) -> torch.Tensor:
        """ortho(M_g) = exp(skew(M_g)) per group, (G, Nper, Nper).

        Inside :meth:`sharing_orthogonal_blocks` it is computed once and
        reused (the loss evaluation of a training step needs it three times:
        loop matrix, sub-FDN output, sparsity loss, as one jitted JAX step
        computes it once).
        """
        if self._shared_blocks is not None:
            if self._shared_blocks[0] is None:
                self._shared_blocks[0] = orthogonal_from_skew(self.M)
            return self._shared_blocks[0]
        return orthogonal_from_skew(self.M)

    @contextlib.contextmanager
    def sharing_orthogonal_blocks(self) -> Iterator[None]:
        """Within the block, :meth:`orthogonal_blocks` is computed once."""
        self._shared_blocks = [None]
        try:
            yield
        finally:
            self._shared_blocks = None

    def block_mixing_matrix(self) -> torch.Tensor:
        """Block matrix with blocks ortho(M_i) @ ortho(M_j), shape (N, N)."""
        o = self.orthogonal_blocks()  # (G, Nper, Nper)
        block = torch.einsum("gab,hbc->gahc", o, o)
        return block.reshape(self.num_delays, self.num_delays)

    def coupling_matrix(self) -> torch.Tensor:
        """Room-level coupling: the (G, G) unitary of the Givens angles
        (SCALAR), or the (order, G, G) FIR paraunitary matrix of the
        column-normalized unit vectors and exp(skew(unitary_matrix)) (FILTER)."""
        if self.coupling_matrix_type is CouplingMatrixType.SCALAR:
            alpha = torch.clamp(self.alpha, -np.pi, np.pi)
            return nd_unitary(alpha, self.num_groups)
        v = self.unit_vectors
        v = v / (torch.linalg.vector_norm(v, dim=0, keepdim=True) + 1e-9)
        return fir_paraunitary(orthogonal_from_skew(self.unitary_matrix), v)

    def coupled_feedback_matrix(self) -> torch.Tensor:
        """A = block_M o (Phi kron 1): (N, N), or (order, N, N) taps of A(z)
        with FILTER coupling; exp(skew(X)) with RANDOM coupling."""
        if self.coupling_matrix_type is CouplingMatrixType.RANDOM:
            return orthogonal_from_skew(self.random_feedback_matrix)
        nper = self.num_delay_lines_per_group
        phi = self.coupling_matrix()
        expand = torch.repeat_interleave(torch.repeat_interleave(phi, nper, -2), nper, -1)
        return self.block_mixing_matrix() * expand

    # -------------------------------- forward -------------------------------

    @property
    def is_block_diagonal(self) -> bool:
        """Zero inter-group SCALAR coupling makes the loop matrix block-diagonal."""
        return self.coupling_matrix_type is CouplingMatrixType.SCALAR and self.use_zero_coupling

    def _inverse_gammas(self, z: torch.Tensor) -> torch.Tensor:
        """1 / Gamma per line: (N, F) complex for filters, (N, 1) real for gains."""
        if self.use_absorption_filters:
            return 1.0 / self.gamma_response(z)
        return (1.0 / self.gamma_scalar())[:, None]

    def loop_matrix_blocks(self, z: torch.Tensor) -> torch.Tensor:
        """Per-group loop matrices (G, F, Nper, Nper) for the zero-coupling case."""
        g, nper = self.num_groups, self.num_delay_lines_per_group
        delays = self.delays.reshape(g, nper)
        d_diag = z[None, :, None] ** delays[:, None, :]  # (G, F, Nper)
        gamma_inv = self._inverse_gammas(z).reshape(g, nper, -1).transpose(1, 2)
        ddecay = (d_diag * gamma_inv).to(torch.complex64)
        o = self.orthogonal_blocks()
        a_blocks = torch.matmul(o, o).to(torch.complex64)  # (G, Nper, Nper)
        return torch.diag_embed(ddecay) - a_blocks[:, None]

    def loop_matrix(self, z: torch.Tensor) -> torch.Tensor:
        """M(z) = D(z) Gamma(z)^-1 - A(z), shape (F, N, N) complex64. With
        FILTER coupling A(z) = sum_o A_o z^-o, one (F, order) x (order, N^2)
        product."""
        d_diag = z[:, None] ** self.delays[None, :]  # (F, N)
        ddecay = (d_diag * self._inverse_gammas(z).T).to(torch.complex64)
        a = self.coupled_feedback_matrix()
        if a.dim() == 3:
            return torch.diag_embed(ddecay) - paraunitary_frequency_response(a, z)
        return torch.diag_embed(ddecay) - a.to(torch.complex64)[None]

    def block_responses(self, z: torch.Tensor) -> torch.Tensor:
        """Per-group responses P_g(z) = loop_matrix_g(z)^-1, (G, F, Nper, Nper)."""
        return cinv(self.loop_matrix_blocks(z))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """P(z) = loop_matrix(z)^-1, shape (F, N, N) complex64."""
        if not self.is_block_diagonal:
            return cinv(self.loop_matrix(z))
        nper = self.num_delay_lines_per_group
        p_blocks = self.block_responses(z)
        p = torch.zeros(
            (z.shape[0], self.num_delays, self.num_delays), dtype=torch.complex64,
            device=z.device,
        )
        for k in range(self.num_groups):
            s = k * nper
            p[:, s:s + nper, s:s + nper] = p_blocks[k]
        return p

    def drive(self, z: torch.Tensor, b_vec: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        """q(z) = P(z) b, or P(z)^T b with ``transpose``, shape (F, N) complex64,
        by the single-RHS LU solve (with the transposed blocks, which the
        solve makes contiguous before its launch)."""
        b_c = b_vec.to(torch.complex64)
        f = z.shape[0]
        if self.is_block_diagonal:
            g, nper = self.num_groups, self.num_delay_lines_per_group
            b_g = b_c.reshape(g, nper)
            m = self.loop_matrix_blocks(z)
            if transpose:
                m = m.transpose(-1, -2)
            q = csolve1(m, b_g[:, None, :].expand(g, f, nper))
            return q.transpose(0, 1).reshape(f, self.num_delays)
        m = self.loop_matrix(z)
        return csolve1(m.transpose(-1, -2) if transpose else m, b_c)
