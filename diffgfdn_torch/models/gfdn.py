"""Differentiable GFDN model (port of ``diffgfdn_tpu/models/gfdn.py``, serving slice).

H(z) = c(z)^T (D(z) Gamma(z)^-1 - A(z))^-1 b(z) + d(z), evaluated at all
rFFT bins at once.

* :class:`DiffGFDN` — io gains, feedback loop and the three transfer-function
  forms (general, per-group filter heads, frequency-independent heads);
* :class:`DiffGFDNVarReceiverPos` — output gains (scalar heads) or SVF
  filters (SVF heads) conditioned on the listener position via an MLP.

The colorless sub-FDN output (``sub_fdn_output``), used only by the
colorless training loss, arrives with the training slice (ROADMAP A5).
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config.schema import CouplingMatrixType, FeatureEncodingType
from .feedback_loop import FeedbackLoop
from .gain_heads import expand_groups_to_delay_lines, GainsFromMLP, SVFFromMLP


def _io_gains(n: int, generator: Optional[torch.Generator]) -> nn.Parameter:
    """(2 * randn - 1) / N, shape (N, 1), as the JAX package initializes b and c."""
    return nn.Parameter((2.0 * torch.randn((n, 1), generator=generator) - 1.0) / n)


class DiffGFDN(nn.Module):
    """Base GFDN: io gains + feedback loop."""

    def __init__(
        self,
        sample_rate: float,
        num_groups: int,
        delays: Sequence[int],
        coupling_matrix_type: CouplingMatrixType = CouplingMatrixType.SCALAR,
        use_zero_coupling: bool = True,
        gains: Optional[np.ndarray] = None,
        sos_coeffs: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.sample_rate = sample_rate
        self.num_groups = num_groups
        self.delays = tuple(int(d) for d in delays)
        self.num_delay_lines = n = len(self.delays)
        self.num_delay_lines_per_group = n // num_groups
        self.input_gains = _io_gains(n, generator)
        self.output_gains = _io_gains(n, generator)
        self.feedback_loop = FeedbackLoop(
            num_groups=num_groups,
            num_delay_lines_per_group=self.num_delay_lines_per_group,
            delays=self.delays,
            coupling_matrix_type=coupling_matrix_type,
            use_zero_coupling=use_zero_coupling,
            gains=gains,
            sos_coeffs=sos_coeffs,
            generator=generator,
        )

    def transfer_function(
        self,
        z: torch.Tensor,
        c: torch.Tensor,
        b: torch.Tensor,
        direct: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """H[b, f] = sum_{n,m} C[b,n,f] P[f,n,m] B[b,m,f] (+ direct).

        ``c``/``b``: (batch, N, F) complex; returns (batch, F) complex.
        """
        p = self.feedback_loop(z)  # (F, N, N)
        t = torch.einsum("bnf,fnm->bmf", c, p)
        h = torch.einsum("bmf,bmf->bf", t, b)
        return h if direct is None else h + direct

    def transfer_function_group_heads(
        self,
        z: torch.Tensor,
        c_group: torch.Tensor,
        direct: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """H for per-GROUP output filter heads via a group-pooled loop response.

        ``s[f,g,h] = sum_{n in g, m in h} c_gain[n] P[f,n,m] b_gain[m]``; with
        zero coupling P is block-diagonal, so s is diagonal and only the
        per-group blocks are inverted. ``c_group``: (B, G, F) complex.
        """
        g, nper = self.num_groups, self.num_delay_lines_per_group
        cw = self.output_gains[:, 0].to(torch.complex64)
        bw = self.input_gains[:, 0].to(torch.complex64)
        if self.feedback_loop.is_block_diagonal:
            pb = self.feedback_loop.block_responses(z)  # (G, F, n, n)
            s_diag = torch.einsum(
                "gfnm,gn,gm->fg", pb, cw.reshape(g, nper), bw.reshape(g, nper)
            )
        else:
            p = self.feedback_loop(z)  # (F, N, N)
            w = cw[None, :, None] * p * bw[None, None, :]
            s_diag = w.reshape(z.shape[0], g, nper, g, nper).sum(dim=(2, 4)).sum(dim=-1)
        h = torch.einsum("bgf,fg->bf", c_group, s_diag)
        return h if direct is None else h + direct

    def transfer_function_scalar_heads(
        self,
        z: torch.Tensor,
        c_scalars: torch.Tensor,
        b_scalars: torch.Tensor,
        direct: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Fast path for frequency-INDEPENDENT heads: H = c~ . (P(f) b~).

        ``c_scalars``: (batch, N) per-line output scalars; ``b_scalars``: (N,).
        """
        q = self.feedback_loop.drive(z, b_scalars).T
        h = torch.matmul(c_scalars.to(torch.complex64), q)  # (B, F)
        return h if direct is None else h + direct


class DiffGFDNVarReceiverPos(DiffGFDN):
    """Output gains/filters conditioned on listener position."""

    def __init__(
        self,
        *args,
        use_svf_in_output: bool = True,
        num_fourier_features: int = 10,
        num_hidden_layers: int = 3,
        num_neurons: int = 128,
        encoding_type: FeatureEncodingType = FeatureEncodingType.SINE,
        compress_pole_factor: float = 1.0,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        super().__init__(*args, generator=generator, **kwargs)
        self.use_svf_in_output = use_svf_in_output
        head = dict(
            num_groups=self.num_groups,
            num_fourier_features=num_fourier_features,
            num_hidden_layers=num_hidden_layers,
            num_neurons=num_neurons,
            encoding_type=encoding_type,
            generator=generator,
        )
        if use_svf_in_output:
            self.output_filters = SVFFromMLP(
                sample_rate=self.sample_rate, compress_pole_factor=compress_pole_factor, **head
            )
        else:
            self.output_scalars = GainsFromMLP(**head)

    def forward(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, F) complex transfer function at the batch's listener positions.

        ``x`` holds ``z_values`` (F,), ``listener_position`` and
        ``norm_listener_position`` (B, 3) and, when present, the
        ``target_early_response`` (B, F) added as the direct part.
        """
        z = x["z_values"]
        direct = x.get("target_early_response")
        if self.use_svf_in_output:
            group_resp = self.output_filters(x)  # (B, G, F) complex
            return self.transfer_function_group_heads(z, group_resp, direct)
        gains = self.output_scalars(x)  # (B, G)
        c_scalars = (
            expand_groups_to_delay_lines(gains, self.num_delay_lines_per_group)
            * self.output_gains[:, 0]
        )
        return self.transfer_function_scalar_heads(
            z, c_scalars, self.input_gains[:, 0], direct
        )
