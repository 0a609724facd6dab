"""Position-conditioned gain / filter heads (port of ``models/gain_heads.py``).

The MLP emits SVF (resonance, gain-dB) grids that are converted to biquad
cascades and evaluated at all z points by the biquad-cascade kernel
(``kernels/sos.py``), or bounded scalar gains per group.
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import FeatureEncodingType
from ..kernels.sos import sos_cascade_response
from ..ops.biquad import SVF_HIGHSHELF, SVF_LOWSHELF, SVF_PEAKING, svf_to_biquad
from ..ops.geq import eq_freqs
from .dnn import MLP, scaled_sigmoid, SinusoidalEncoding


def svf_cutoff_frequencies(sample_rate: float) -> np.ndarray:
    """Normalized SVF cutoffs: pi * [low-shelf xover, octave centres, high xover] / fs."""
    centre, shelving = eq_freqs()
    freqs = np.concatenate(([shelving[0]], centre, [shelving[-1]]))
    return np.pi * freqs / sample_rate


def svf_filter_types(num_biquads: int) -> np.ndarray:
    """Cascade types: low shelf, peaking ... peaking, high shelf."""
    types = np.full(num_biquads, SVF_PEAKING, dtype=np.int32)
    types[0] = SVF_LOWSHELF
    types[-1] = SVF_HIGHSHELF
    return types


def svf_params_to_response(
    svf_params: torch.Tensor,
    cutoffs,
    z: torch.Tensor,
    compress_pole_factor: float = 1.0,
    filter_types: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Constrained SVF params -> cascade frequency response.

    ``svf_params``: (..., K, 2) raw MLP outputs; channel 0 is resonance
    (constrained to (1e-6, 1)), channel 1 gain in dB (constrained to
    (-6, 6)). ``cutoffs`` (K,) and ``filter_types`` (K,), when given as
    tensors on the parameters' device, are used without a host copy.
    Returns (response (..., F), num (..., K, 3), den (..., K, 3)).
    """
    res = scaled_sigmoid(svf_params[..., 0], 1e-6, 1.0)
    g_db = scaled_sigmoid(svf_params[..., 1], -6.0, 6.0)
    k = svf_params.shape[-2]
    shape = (1,) * (svf_params.dim() - 2) + (k,)
    dev = svf_params.device
    if filter_types is None:
        filter_types = svf_filter_types(k)
    ftypes = torch.as_tensor(filter_types, device=dev).reshape(shape)
    cut = torch.as_tensor(cutoffs, dtype=torch.float32, device=dev).reshape(shape)
    num, den = svf_to_biquad(cut, res, ftypes, g_db, compress_pole_factor)
    return sos_cascade_response(num, den, z), num, den


def _check_encoding(encoding_type: FeatureEncodingType) -> None:
    if encoding_type != FeatureEncodingType.SINE:
        raise NotImplementedError(
            "meshgrid position encoding is not ported yet (ROADMAP A4)"
        )


class SVFFromMLP(nn.Module):
    """MLP: position -> SVF cascade per group -> (B, G, F) complex responses."""

    def __init__(
        self,
        sample_rate: float,
        num_groups: int,
        num_fourier_features: int,
        num_hidden_layers: int,
        num_neurons: int,
        encoding_type: FeatureEncodingType = FeatureEncodingType.SINE,
        compress_pole_factor: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_encoding(encoding_type)
        self.cutoffs = svf_cutoff_frequencies(sample_rate)
        # device copies of the constants, so a forward uploads nothing
        self.register_buffer(
            "cutoff_values", torch.as_tensor(self.cutoffs, dtype=torch.float32),
            persistent=False,
        )
        self.register_buffer(
            "filter_types", torch.as_tensor(svf_filter_types(len(self.cutoffs))),
            persistent=False,
        )
        self.compress_pole_factor = compress_pole_factor
        self.encoding = SinusoidalEncoding(num_fourier_features)
        self.mlp = MLP(
            3 * 2 * num_fourier_features, num_hidden_layers, num_neurons, num_groups,
            len(self.cutoffs), 2, generator=generator,
        )

    def forward(self, x: dict, return_params: bool = False):
        """(B, G, F) complex responses at ``x["z_values"]``; with
        ``return_params`` also the constrained SVF parameters and the biquads
        as {"svf_params" (B, G, K, 2), "biquad_num", "biquad_den"}."""
        svf = self.mlp(self.encoding(x["listener_position"]))  # (B, G, K, 2)
        resp, num, den = svf_params_to_response(
            svf, self.cutoff_values, x["z_values"], self.compress_pole_factor,
            self.filter_types,
        )
        if return_params:
            res = scaled_sigmoid(svf[..., 0], 1e-6, 1.0)
            g_db = scaled_sigmoid(svf[..., 1], -6.0, 6.0)
            return resp, {
                "svf_params": torch.stack([res, g_db], dim=-1),
                "biquad_num": num,
                "biquad_den": den,
            }
        return resp


class GainsFromMLP(nn.Module):
    """MLP: position -> bounded scalar gain per group, shape (B, G)."""

    def __init__(
        self,
        num_groups: int,
        num_fourier_features: int,
        num_hidden_layers: int,
        num_neurons: int,
        encoding_type: FeatureEncodingType = FeatureEncodingType.SINE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _check_encoding(encoding_type)
        self.encoding = SinusoidalEncoding(num_fourier_features)
        self.mlp = MLP(
            3 * 2 * num_fourier_features, num_hidden_layers, num_neurons, num_groups,
            1, 1, generator=generator,
        )

    def forward(self, x: dict) -> torch.Tensor:
        out = self.mlp(self.encoding(x["norm_listener_position"]))
        return scaled_sigmoid(out[..., 0, 0], -1.0, 1.0)


def expand_groups_to_delay_lines(
    per_group: torch.Tensor, num_delay_lines_per_group: int, axis: int = 1
) -> torch.Tensor:
    """Repeat per-group values so each delay line in a group shares them."""
    return torch.repeat_interleave(per_group, num_delay_lines_per_group, dim=axis)
