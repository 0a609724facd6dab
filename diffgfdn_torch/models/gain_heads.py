"""Position-conditioned gain / filter heads (port of ``models/gain_heads.py``).

The MLP emits SVF (resonance, gain-dB) grids that are converted to biquad
cascades and evaluated at all z points by the biquad-cascade kernel
(``kernels/sos.py``), or bounded scalar gains per group. It reads the
position's Fourier features (SINE encoding) or the one-hot floor-plan mesh
(MESHGRID: run over the mesh, then looked up at each position).
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import FeatureEncodingType
from ..kernels.sos import sos_cascade_response
from ..ops.biquad import SVF_HIGHSHELF, SVF_LOWSHELF, SVF_PEAKING, svf_to_biquad
from ..ops.geq import eq_freqs
from .dnn import MLP, one_hot_mesh_encoding, scaled_sigmoid, SinusoidalEncoding


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


def svf_params_to_biquads(
    svf_params: torch.Tensor,
    cutoffs,
    compress_pole_factor: float = 1.0,
    filter_types: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constrained SVF params -> biquad (num, den) triples (..., K, 3).

    ``svf_params``: (..., K, 2) raw MLP outputs; channel 0 is resonance
    (constrained to (1e-6, 1)), channel 1 gain in dB (constrained to
    (-6, 6)). ``cutoffs`` (K,) and ``filter_types`` (K,), when given as
    tensors on the parameters' device, are used without a host copy.
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
    return svf_to_biquad(cut, res, ftypes, g_db, compress_pole_factor)


def svf_params_to_response(
    svf_params: torch.Tensor,
    cutoffs,
    z: torch.Tensor,
    compress_pole_factor: float = 1.0,
    filter_types: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Constrained SVF params -> cascade frequency response at z (the
    cascade kernel): (response (..., F), num (..., K, 3), den (..., K, 3)),
    the biquads as :func:`svf_params_to_biquads` makes them."""
    num, den = svf_params_to_biquads(svf_params, cutoffs, compress_pole_factor, filter_types)
    return sos_cascade_response(num, den, z), num, den


class _PositionMLP(nn.Module):
    """An MLP's position encoding and lookup, shared by both head kinds.

    ``encoding_type`` SINE: the MLP reads the Fourier features of the batch's
    ``position_key`` entry. MESHGRID: it reads the one-hot floor-plan mesh
    (``mesh_2d`` (L, 2) in the batch, the mesh points' (x, y) and a 1 at the
    point nearest each position: input width 3), runs once over all L mesh
    points, and each position takes its nearest point's output; the lookup
    reads the raw ``lookup_key`` position, in metres as the mesh is.
    """

    def __init__(self, encoding_type: FeatureEncodingType, num_fourier_features: int,
                 position_key: str, lookup_key: str):
        super().__init__()
        self.encoding_type = FeatureEncodingType(encoding_type)
        self.position_key = position_key
        self.lookup_key = lookup_key
        self.encoding = SinusoidalEncoding(num_fourier_features)
        self.in_features = (3 * 2 * num_fourier_features
                            if self.encoding_type is FeatureEncodingType.SINE else 3)

    def run(self, mlp: nn.Module, x: dict) -> torch.Tensor:
        if self.encoding_type is FeatureEncodingType.SINE:
            return mlp(self.encoding(x[self.position_key]))
        mesh_inp, _, rec_idx = one_hot_mesh_encoding(x["mesh_2d"], x[self.lookup_key])
        return mlp(mesh_inp)[rec_idx]


def uses_meshgrid(model: nn.Module) -> bool:
    """Whether any head of ``model`` reads the floor-plan mesh (``mesh_2d``)."""
    return any(isinstance(m, _PositionMLP) and m.encoding_type is FeatureEncodingType.MESHGRID
               for m in model.modules())


class SVFFromMLP(nn.Module):
    """MLP: position -> SVF cascade per group -> (B, G, F) complex responses.

    ``position_key``: the batch entry the MLP reads (the listener's raw
    position by default; a source head reads ``"source_position"``); with
    meshgrid encoding, the position looked up on the mesh."""

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
        position_key: str = "listener_position",
    ):
        super().__init__()
        self.position_key = position_key
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
        self.position = _PositionMLP(encoding_type, num_fourier_features, position_key,
                                     position_key)
        self.mlp = MLP(
            self.position.in_features, num_hidden_layers, num_neurons, num_groups,
            len(self.cutoffs), 2, generator=generator,
        )

    def biquads(self, x: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """The heads' biquad cascades (num, den), each (B, G, K, 3), without
        their responses (the aliasing regularizer's input)."""
        return svf_params_to_biquads(self.position.run(self.mlp, x), self.cutoff_values,
                                     self.compress_pole_factor, self.filter_types)

    def forward(self, x: dict, return_params: bool = False):
        """(B, G, F) complex responses at ``x["z_values"]``; with
        ``return_params`` also the constrained SVF parameters and the biquads
        as {"svf_params" (B, G, K, 2), "biquad_num", "biquad_den"}."""
        svf = self.position.run(self.mlp, x)  # (B, G, K, 2)
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
    """MLP: position -> bounded scalar gain per group, shape (B, G).

    ``position_key``: the batch entry the MLP reads (the listener's
    normalized position by default; a source head reads the raw
    ``"source_position"``). With meshgrid encoding a listener head looks up
    the raw ``listener_position`` on the mesh (as JAX's does; the mesh is in
    metres), a source head its ``"source_position"`` (JAX's source head
    looks up the listener's: ROADMAP C19)."""

    def __init__(
        self,
        num_groups: int,
        num_fourier_features: int,
        num_hidden_layers: int,
        num_neurons: int,
        encoding_type: FeatureEncodingType = FeatureEncodingType.SINE,
        generator: Optional[torch.Generator] = None,
        position_key: str = "norm_listener_position",
    ):
        super().__init__()
        self.position_key = position_key
        lookup = "listener_position" if position_key == "norm_listener_position" else position_key
        self.position = _PositionMLP(encoding_type, num_fourier_features, position_key, lookup)
        self.mlp = MLP(
            self.position.in_features, num_hidden_layers, num_neurons, num_groups,
            1, 1, generator=generator,
        )

    def forward(self, x: dict) -> torch.Tensor:
        out = self.position.run(self.mlp, x)
        return scaled_sigmoid(out[..., 0, 0], -1.0, 1.0)


def expand_groups_to_delay_lines(
    per_group: torch.Tensor, num_delay_lines_per_group: int, axis: int = 1
) -> torch.Tensor:
    """Repeat per-group values so each delay line in a group shares them."""
    return torch.repeat_interleave(per_group, num_delay_lines_per_group, dim=axis)
