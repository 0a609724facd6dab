"""GFDN feedback loop: P(z) = (D(z) Gamma(z)^-1 - A(z))^-1 at all rFFT bins.

Port of ``diffgfdn_tpu/models/feedback_loop.py`` for SCALAR coupling (zero
coupling, or learned Givens angles) and RANDOM coupling (one dense
orthogonal matrix exp(skew(X)), as the colorless prototype FDN uses). The
per-bin inverse and solve go through ``kernels/linalg.py`` (Gauss-Jordan and
LU kernels), the absorption cascades through the biquad-cascade kernel.

Absorption: fixed per-line scalar gains (``gains``) or fixed per-line SOS
cascades fitted by the GEQ designer (``sos_coeffs``).
"""

import contextlib
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config.schema import CouplingMatrixType
from ..kernels.linalg import cinv, csolve1
from ..kernels.sos import sos_cascade_response
from ..ops.unitary import nd_unitary, orthogonal_from_skew


class FeedbackLoop(nn.Module):
    """Coupled feedback loop of the grouped FDN.

    ``delays``: per-line lengths in samples (N); ``gains``: fixed per-line
    absorption gains (N,); ``sos_coeffs``: (N, n_sections, 3, 2) absorption
    cascades, (num, den) on the last axis. Parameters, SCALAR coupling: ``M``
    (G, Nper, Nper) skew pre-images and, with learned coupling, ``alpha``
    (G(G-1)/2 angles); ``colorless_feedback_matrix_skew`` (G, Nper, Nper)
    initializes ``M`` (the colorless prototypes' optima, :mod:`..training.build`).
    RANDOM coupling: ``random_feedback_matrix`` (N, N), whose exp(skew(.))
    is the whole loop's feedback matrix.
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
    ):
        super().__init__()
        self.coupling_matrix_type = CouplingMatrixType(coupling_matrix_type)
        if self.coupling_matrix_type is CouplingMatrixType.FILTER:
            raise NotImplementedError(
                "coupling_matrix_type=filter_matrix is not ported yet (ROADMAP A4); "
                "SCALAR and RANDOM coupling are"
            )
        if (gains is None) == (sos_coeffs is None):
            raise ValueError("give exactly one of gains or sos_coeffs")
        self.num_groups = g = num_groups
        self.num_delay_lines_per_group = nper = num_delay_lines_per_group
        self.num_delays = len(delays)
        self.use_zero_coupling = use_zero_coupling
        self.register_buffer(
            "delays", torch.as_tensor(np.asarray(delays), dtype=torch.float32),
            persistent=False,
        )
        self.register_buffer(
            "gains",
            None if gains is None else torch.as_tensor(np.asarray(gains), dtype=torch.float32),
            persistent=False,
        )
        self.register_buffer(
            "sos_coeffs",
            None if sos_coeffs is None
            else torch.as_tensor(np.asarray(sos_coeffs), dtype=torch.float32),
            persistent=False,
        )
        # the designed cascades as given (float64 from the GEQ fit): the
        # time-domain path builds its state-space constants from them
        self.sos_coeffs_host = None if sos_coeffs is None else np.asarray(sos_coeffs)
        self._shared_blocks = None
        if self.coupling_matrix_type is CouplingMatrixType.RANDOM:
            n = self.num_delays
            self.random_feedback_matrix = nn.Parameter(
                (2.0 * torch.rand((n, n), generator=generator) - 1.0) / np.sqrt(nper)
            )
            return
        if colorless_feedback_matrix_skew is not None:
            self.M = nn.Parameter(torch.as_tensor(
                np.asarray(colorless_feedback_matrix_skew), dtype=torch.float32).clone())
        else:
            self.M = nn.Parameter(
                (2.0 * torch.rand((g, nper, nper), generator=generator) - 1.0) / np.sqrt(nper)
            )
        n_alpha = g * (g - 1) // 2
        if use_zero_coupling:
            self.register_buffer("alpha", torch.zeros(n_alpha), persistent=False)
        else:
            self.alpha = nn.Parameter(np.pi / 4 * torch.rand((n_alpha,), generator=generator))

    # ------------------------------ absorption ------------------------------

    @property
    def use_absorption_filters(self) -> bool:
        return self.sos_coeffs is not None

    def gamma_scalar(self) -> torch.Tensor:
        """Per-line scalar absorption gains, shape (N,)."""
        return self.gains

    def gamma_response(self, z: torch.Tensor) -> torch.Tensor:
        """Per-line absorption filter responses, shape (N, F) complex64."""
        return sos_cascade_response(self.sos_coeffs[..., 0], self.sos_coeffs[..., 1], z)

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
        """Room-level (G, G) unitary coupling from the Givens angles."""
        alpha = torch.clamp(self.alpha, -np.pi, np.pi)
        return nd_unitary(alpha, self.num_groups)

    def coupled_feedback_matrix(self) -> torch.Tensor:
        """A = block_M o (Phi kron 1), or exp(skew(X)) with RANDOM coupling; (N, N)."""
        if self.coupling_matrix_type is CouplingMatrixType.RANDOM:
            return orthogonal_from_skew(self.random_feedback_matrix)
        nper = self.num_delay_lines_per_group
        phi = self.coupling_matrix()
        expand = torch.repeat_interleave(torch.repeat_interleave(phi, nper, 0), nper, 1)
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
        """M(z) = D(z) Gamma(z)^-1 - A, shape (F, N, N) complex64."""
        d_diag = z[:, None] ** self.delays[None, :]  # (F, N)
        ddecay = (d_diag * self._inverse_gammas(z).T).to(torch.complex64)
        a = self.coupled_feedback_matrix().to(torch.complex64)
        return torch.diag_embed(ddecay) - a[None]

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
