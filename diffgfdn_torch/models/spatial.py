"""Common-slopes and directional beamforming heads (port of ``diffgfdn_tpu/models/spatial.py``).

:func:`build_analysis_matrix` designs the SH-domain analysis matrix on the
host (``ops/sph.py``); :class:`DirectionalBeamformerWeightsMLP` maps a
receiver position to per-group SH beamforming weights, and
:func:`directional_amplitudes` turns them into per-direction common-slope
amplitudes; :class:`DirectionalBeamformerWeightsCNN` maps the whole
floor-plan grid to those weights at once; :class:`OmniAmplitudesMLP` maps a
position to omni common-slope amplitudes.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config.schema import BeamformerType
from ..ops.sph import design_sph_filterbank, modal_weights
from .dnn import ConvNet, MLP, MLPSkipConnections, scaled_sigmoid, sigmoid, SinusoidalEncoding


def build_analysis_matrix(
    ambi_order: int,
    desired_directions: np.ndarray,
    beamformer_type: Optional[BeamformerType],
) -> np.ndarray:
    """SH-domain analysis (beamforming) matrix (num_directions, (N+1)^2) float32.

    ``desired_directions``: (2, J) (azimuth, elevation) in radians; the
    design takes the colatitude pi/2 - elevation.
    """
    c_n = modal_weights(beamformer_type, ambi_order)
    azi = desired_directions[0]
    colat = np.pi / 2 - desired_directions[1]
    analysis, _ = design_sph_filterbank(ambi_order, azi, colat, c_n, mode="energy")
    return analysis.astype(np.float32)


def normalise_weights(weights: torch.Tensor) -> torch.Tensor:
    """Unit-energy normalization along the SH-component axis."""
    return weights / (torch.linalg.vector_norm(weights, dim=-1, keepdim=True) + 1e-6)


def directional_amplitudes(analysis_matrix: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sigmoid(Y_analysis @ w): (B, num_directions, num_slopes).

    ``analysis_matrix``: (num_directions, (N+1)^2); ``weights``:
    (B, num_slopes, (N+1)^2).
    """
    return sigmoid(torch.einsum("jn,bkn->bjk", analysis_matrix, weights))


class DirectionalBeamformerWeightsMLP(nn.Module):
    """MLP: receiver position -> SH beamforming weights (B, num_groups, (ambi_order+1)^2).

    The MLP is ``skip_mlp`` (residual blocks) with ``use_skip_connections``,
    else ``mlp``: the names the parameter mapping (``utils/params.py``) gives
    the flax modules ``MLPSkipConnections_0`` and ``MLP_0``.
    """

    def __init__(
        self,
        num_groups: int,
        ambi_order: int,
        num_fourier_features: int,
        num_hidden_layers: int,
        num_neurons: int,
        use_skip_connections: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_groups = num_groups
        self.num_out = (ambi_order + 1) ** 2
        self.encoding = SinusoidalEncoding(num_fourier_features)
        args = (3 * num_fourier_features * 2, num_hidden_layers, num_neurons, num_groups, 1,
                self.num_out)
        if use_skip_connections:
            self.skip_mlp = MLPSkipConnections(*args, generator=generator)
        else:
            self.mlp = MLP(*args, generator=generator)

    def forward(self, x: dict, normalise: bool = False) -> torch.Tensor:
        position = x["norm_listener_position"]
        net = self.skip_mlp if hasattr(self, "skip_mlp") else self.mlp
        out = net(self.encoding(position))
        weights = out.reshape(position.shape[0], self.num_groups, self.num_out)
        return normalise_weights(weights) if normalise else weights


class DirectionalBeamformerWeightsCNN(nn.Module):
    """CNN over the floor-plan mesh -> SH beamforming weights per slope.

    The batch's ``mesh_2d`` (H, W, 2) (normalized coordinates) is Fourier
    encoded cell by cell, then the :class:`ConvNet` ``cnn`` (flax
    ``ConvNet_0``) maps the (H, W, 4 * num_fourier_features) features to
    weights (H*W, num_groups, (ambi_order+1)^2), cells in row-major order.
    """

    def __init__(
        self,
        num_groups: int,
        ambi_order: int,
        num_fourier_features: int,
        num_hidden_channels: int,
        num_layers: int = 3,
        kernel_size: Sequence[int] = (3, 3),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_groups = num_groups
        self.num_out = (ambi_order + 1) ** 2
        self.encoding = SinusoidalEncoding(num_fourier_features)
        self.cnn = ConvNet(2 * num_fourier_features * 2, self.num_out, num_groups,
                           num_hidden_channels, num_layers, kernel_size, generator=generator)

    def forward(self, x: dict) -> torch.Tensor:
        mesh = x["mesh_2d"]
        h, w, ncoord = mesh.shape
        feats = self.encoding(mesh.reshape(h * w, ncoord)).reshape(h, w, -1)
        return self.cnn(feats).reshape(h * w, self.num_groups, self.num_out)


class OmniAmplitudesMLP(nn.Module):
    """MLP: receiver position -> omni common-slope amplitudes (B, num_groups)
    in ``gain_limits``. The MLP is ``mlp`` (flax ``MLP_0``)."""

    def __init__(
        self,
        num_groups: int,
        num_fourier_features: int,
        num_hidden_layers: int,
        num_neurons: int,
        gain_limits: Tuple[float, float] = (-1.0, 1.0),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.gain_limits = gain_limits
        self.encoding = SinusoidalEncoding(num_fourier_features)
        self.mlp = MLP(3 * num_fourier_features * 2, num_hidden_layers, num_neurons, num_groups,
                       1, 1, generator=generator)

    def forward(self, x: dict) -> torch.Tensor:
        gains = self.mlp(self.encoding(x["norm_listener_position"]))[..., 0, 0]
        return scaled_sigmoid(gains, self.gain_limits[0], self.gain_limits[1])
