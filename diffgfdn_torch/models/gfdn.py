"""Differentiable GFDN model (port of ``diffgfdn_tpu/models/gfdn.py``).

H(z) = c(z)^T (D(z) Gamma(z)^-1 - A(z))^-1 b(z) + d(z), evaluated at all
rFFT bins at once.

* :class:`DiffGFDN` — io gains (learned, or fixed by a colorless
  prototype), feedback loop, the three transfer-function forms (general,
  per-group filter heads, frequency-independent heads) and the lossless
  per-group responses ``sub_fdn_output``;
* :class:`DiffGFDNVarReceiverPos` — output gains (scalar heads) or SVF
  filters (SVF heads) conditioned on the listener position via an MLP;
* :class:`DiffGFDNSinglePos` — one source / receiver pair: per-group scalars
  or SVF cascades as plain parameters, on the output and the input side;
* :class:`DiffDirectionalFDNVarReceiverPos` — SH-domain output gains for
  directional (ambisonic) FDNs: (B, (ambi_order + 1)^2, F) per position.

``forward`` returns H alone: the trainer calls ``sub_fdn_output`` itself
when the colorless loss is on, so serving never computes it.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import CouplingMatrixType, FeatureEncodingType
from ..kernels.linalg import cinv
from .feedback_loop import FeedbackLoop
from .gain_heads import (
    expand_groups_to_delay_lines,
    GainsFromMLP,
    svf_cutoff_frequencies,
    svf_filter_types,
    svf_params_to_response,
    SVFFromMLP,
)
from .spatial import DirectionalBeamformerWeightsMLP


BIN_CHUNK = 1024


def _sum_over_lines(c: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """h[b, f] = sum_n c[b, n] q[f, n]: (B, N), (F, N) -> (B, F).

    The bins are cut into S chunks of at most ``BIN_CHUNK`` and c is repeated over
    them, so c's gradient is S short products summed, not one product whose
    reduction runs over all F bins. Under ``torch.func.vmap`` the long one
    becomes a batched product that runs on a few blocks (2.9 ms at 65537 bins
    against 0.05 unbatched on the H100)."""
    f, n = q.shape
    s = -(-f // BIN_CHUNK)
    size = -(-f // s)
    qs = nn.functional.pad(q, (0, 0, 0, s * size - f)).reshape(s, size, n)
    cs = c.expand(s, *c.shape)
    h = torch.matmul(cs, qs.transpose(1, 2))  # (S, B, size)
    return h.transpose(0, 1).reshape(c.shape[0], s * size)[:, :f]


def _io_gains(n: int, generator: Optional[torch.Generator]) -> nn.Parameter:
    """(2 * randn - 1) / N, shape (N, 1), as the JAX package initializes b and c."""
    return nn.Parameter((2.0 * torch.randn((n, 1), generator=generator) - 1.0) / n)


class DiffGFDN(nn.Module):
    """Base GFDN: io gains + feedback loop.

    ``fixed_input_gains`` / ``fixed_output_gains`` (N,) and
    ``colorless_feedback_matrix_skew`` (G, Nper, Nper) warm-start the model
    from colorless prototypes: the io gains are then buffers, not parameters
    (the optimizer and the checkpoints do not see them), and ``M`` starts at
    the prototypes' optima.
    """

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
        fixed_input_gains: Optional[np.ndarray] = None,
        fixed_output_gains: Optional[np.ndarray] = None,
        colorless_feedback_matrix_skew: Optional[np.ndarray] = None,
    ):
        super().__init__()
        self.sample_rate = sample_rate
        self.num_groups = num_groups
        self.delays = tuple(int(d) for d in delays)
        self.num_delay_lines = n = len(self.delays)
        self.num_delay_lines_per_group = n // num_groups
        for name, fixed in (("input_gains", fixed_input_gains),
                            ("output_gains", fixed_output_gains)):
            if fixed is None:
                setattr(self, name, _io_gains(n, generator))
            else:
                self.register_buffer(name, torch.as_tensor(
                    np.asarray(fixed), dtype=torch.float32).reshape(n, 1), persistent=False)
        self.feedback_loop = FeedbackLoop(
            num_groups=num_groups,
            num_delay_lines_per_group=self.num_delay_lines_per_group,
            delays=self.delays,
            coupling_matrix_type=coupling_matrix_type,
            use_zero_coupling=use_zero_coupling,
            gains=gains,
            sos_coeffs=sos_coeffs,
            generator=generator,
            colorless_feedback_matrix_skew=colorless_feedback_matrix_skew,
        )

    @property
    def io_gains_fixed(self) -> bool:
        """Whether the io gains are fixed (a colorless warm start)."""
        return not isinstance(self.input_gains, nn.Parameter)

    def sub_fdn_inverse(self, z: torch.Tensor) -> torch.Tensor:
        """P_g(z) = (diag(z^m) - ortho(M_g))^-1 of each lossless sub-FDN,
        (G, F, Nper, Nper), through the Gauss-Jordan kernel. It depends on M
        alone, not on the io gains."""
        g, nper = self.num_groups, self.num_delay_lines_per_group
        fl = self.feedback_loop
        delays = fl.delays.reshape(g, nper)
        o = fl.orthogonal_blocks().to(torch.complex64)  # (G, Nper, Nper)
        d = (z[None, :, None] ** delays[:, None, :]).to(torch.complex64)  # (G, F, Nper)
        return cinv(torch.diag_embed(d) - o[:, None])

    def sub_fdn_output(
        self, z: torch.Tensor, p: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Lossless response of each sub-FDN (no absorption, no coupling).

        Returns (Hout (F, G), Hout_per_del (G, Nper, F)): the per-group output
        and the per-delay-line contributions c_n (P b)_n, with P the given
        :meth:`sub_fdn_inverse` at z or, when None, computed here.
        """
        g, nper = self.num_groups, self.num_delay_lines_per_group
        if p is None:
            p = self.sub_fdn_inverse(z)
        c = self.output_gains.reshape(g, nper).to(torch.complex64)
        b = self.input_gains.reshape(g, nper).to(torch.complex64)
        h_per_del = c[:, :, None] * torch.einsum("gfnm,gm->gnf", p, b)
        return h_per_del.sum(dim=1).T, h_per_del

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
        b_group: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """H for per-GROUP filter heads via a group-pooled loop response.

        ``s[f,g,h] = sum_{n in g, m in h} c_gain[n] P[f,n,m] b_gain[m]``; with
        zero coupling P is block-diagonal, so s is diagonal and only the
        per-group blocks are inverted. ``c_group``: (B, G, F) complex;
        ``b_group``: (B, G, F) complex input heads, or None when the input
        side is the io gains alone.
        """
        g, nper = self.num_groups, self.num_delay_lines_per_group
        cw = self.output_gains[:, 0].to(torch.complex64)
        bw = self.input_gains[:, 0].to(torch.complex64)
        if self.feedback_loop.is_block_diagonal:
            pb = self.feedback_loop.block_responses(z)  # (G, F, n, n)
            s_diag = torch.einsum(
                "gfnm,gn,gm->fg", pb, cw.reshape(g, nper), bw.reshape(g, nper)
            )
            if b_group is None:
                h = torch.einsum("bgf,fg->bf", c_group, s_diag)
            else:
                h = torch.einsum("bgf,fg,bgf->bf", c_group, s_diag, b_group)
        else:
            p = self.feedback_loop(z)  # (F, N, N)
            w = cw[None, :, None] * p * bw[None, None, :]
            s = w.reshape(z.shape[0], g, nper, g, nper).sum(dim=(2, 4))  # (F, G, G)
            if b_group is None:
                h = torch.einsum("bgf,fg->bf", c_group, s.sum(dim=-1))
            else:
                h = torch.einsum("bgf,fgh,bhf->bf", c_group, s, b_group)
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
        q = self.feedback_loop.drive(z, b_scalars)  # (F, N)
        h = _sum_over_lines(c_scalars.to(torch.complex64), q)
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

    def forward(
        self, x: Dict[str, torch.Tensor], output_scalars: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, F) complex transfer function at the batch's listener positions.

        ``x`` holds ``z_values`` (F,), ``listener_position`` and
        ``norm_listener_position`` (B, 3) and, when present, the
        ``target_early_response`` (B, F) added as the direct part.
        ``output_scalars`` (B, G), given to a scalar-head model, replace the
        head's per-group gains (externally provided common-slope amplitudes).
        """
        z = x["z_values"]
        direct = x.get("target_early_response")
        if self.use_svf_in_output:
            group_resp = self.output_filters(x)  # (B, G, F) complex
            return self.transfer_function_group_heads(z, group_resp, direct)
        gains = self.output_scalars(x) if output_scalars is None else output_scalars  # (B, G)
        c_scalars = (
            expand_groups_to_delay_lines(gains, self.num_delay_lines_per_group)
            * self.output_gains[:, 0]
        )
        return self.transfer_function_scalar_heads(
            z, c_scalars, self.input_gains[:, 0], direct
        )

    def head_outputs(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-position head outputs: {"gains" (B, G)} for scalar heads, the
        SVF parameters and biquads for SVF heads."""
        if self.use_svf_in_output:
            _, params = self.output_filters(x, return_params=True)
            return params
        return {"gains": self.output_scalars(x)}


class DiffGFDNSinglePos(DiffGFDN):
    """Single source / receiver fit with direct per-group parameters.

    Each side (output, input) is either a per-group SVF cascade (raw
    parameters ``<side>_svf_params`` (G, K, 2), evaluated by the cascade
    kernel) or a per-group scalar (``<side>_scalars`` (G, 1), 1/sqrt(G) at
    first). ``forward`` returns H (F,) with the direct part added.
    """

    def __init__(
        self,
        *args,
        use_svf_in_output: bool = False,
        use_svf_in_input: bool = False,
        compress_pole_factor: float = 1.0,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        super().__init__(*args, generator=generator, **kwargs)
        self.use_svf_in_output = use_svf_in_output
        self.use_svf_in_input = use_svf_in_input
        self.compress_pole_factor = compress_pole_factor
        g = self.num_groups
        cutoffs = svf_cutoff_frequencies(self.sample_rate)
        self.register_buffer("cutoff_values", torch.as_tensor(cutoffs, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("filter_types", torch.as_tensor(svf_filter_types(len(cutoffs))),
                             persistent=False)
        for side, svf in (("output", use_svf_in_output), ("input", use_svf_in_input)):
            if svf:
                init = torch.randn((g, len(cutoffs), 2), generator=generator)
                init[..., 1] = 0.0  # a random resonance, a 0 dB gain
                setattr(self, f"{side}_svf_params", nn.Parameter(init))
            else:
                setattr(self, f"{side}_scalars", nn.Parameter(torch.ones((g, 1)) / np.sqrt(g)))

    def group_response(self, z: torch.Tensor, side: str) -> torch.Tensor:
        """(G, F) complex response of the ``side`` ("output" or "input") head."""
        if getattr(self, f"use_svf_in_{side}"):
            resp, _, _ = svf_params_to_response(
                getattr(self, f"{side}_svf_params"), self.cutoff_values, z,
                self.compress_pole_factor, self.filter_types,
            )
            return resp
        scalars = getattr(self, f"{side}_scalars")[:, :1].to(torch.complex64)
        return scalars.expand(self.num_groups, z.shape[0])

    def forward(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(F,) complex transfer function at ``x["z_values"]``, plus
        ``x["target_early_response"]`` (F,) when present."""
        z = x["z_values"]
        direct = x.get("target_early_response")
        h = self.transfer_function_group_heads(
            z, self.group_response(z, "output")[None],
            None if direct is None else direct[None],
            b_group=self.group_response(z, "input")[None],
        )
        return h[0]


class DiffDirectionalFDNVarReceiverPos(DiffGFDN):
    """Directional (ambisonic) FDN with SH-domain output gains from an MLP.

    Each group has (ambi_order + 1)^2 delay lines, one per SH channel;
    ``forward`` returns (B, (ambi_order + 1)^2, F). ``analysis_matrix``
    (J, (ambi_order + 1)^2) beamforms SH responses to J directions.
    """

    use_svf_in_output = False  # frequency-independent heads: per-step normalization

    def __init__(
        self,
        *args,
        ambi_order: int = 2,
        num_fourier_features: int = 10,
        num_hidden_layers: int = 3,
        num_neurons: int = 128,
        use_skip_connections: bool = False,
        analysis_matrix: Optional[np.ndarray] = None,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        super().__init__(*args, generator=generator, **kwargs)
        if self.num_delay_lines_per_group != (ambi_order + 1) ** 2:
            raise ValueError("delay lines per group must equal the number of ambisonic channels")
        self.ambi_order = ambi_order
        self.sh_output_scalars = DirectionalBeamformerWeightsMLP(
            num_groups=self.num_groups, ambi_order=ambi_order,
            num_fourier_features=num_fourier_features, num_hidden_layers=num_hidden_layers,
            num_neurons=num_neurons, use_skip_connections=use_skip_connections,
            generator=generator,
        )
        self.register_buffer(
            "analysis_matrix",
            None if analysis_matrix is None
            else torch.as_tensor(np.asarray(analysis_matrix, np.float32)),
            persistent=False,
        )

    def sh_weights(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, G, L) per-line output weights: the normalized SH gains of each
        position times the output gains."""
        g, nper = self.num_groups, self.num_delay_lines_per_group
        sh_gains = self.sh_output_scalars(x, normalise=True)
        return sh_gains * self.output_gains.reshape(g, nper)[None]

    def forward(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, L, F) complex SH-domain transfer functions at the batch's positions.

        The drive reads the transposed loop, q = P(z)^T b, solved once for
        all positions; each group's L lines then mix with the position's
        weights, summed over the groups: h[b, a, f] = sum_g w[b, g, a] q[g, a, f].
        """
        z = x["z_values"]
        g, nper, f = self.num_groups, self.num_delay_lines_per_group, z.shape[0]
        q = self.feedback_loop.drive(z, self.input_gains[:, 0], transpose=True)
        q = q.T.reshape(g, nper, f)
        return torch.einsum("bga,gaf->baf", self.sh_weights(x).to(torch.complex64), q)

    def directional_response(self, h_sh: torch.Tensor) -> torch.Tensor:
        """SH-domain responses (B, L, K) -> directional (B, J, K) by the analysis matrix."""
        return torch.einsum("jl,blk->bjk", self.analysis_matrix.to(h_sh.dtype), h_sh)
