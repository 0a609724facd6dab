"""DNN building blocks (port of ``diffgfdn_tpu/models/dnn.py``: sigmoids, MLPs, the encoding).

Layer order, initializers and LayerNorm epsilon follow the flax modules so
that parameters carried over from the JAX package (``utils/params.py``)
give the same function: a flax ``Dense.kernel`` (in, out) is the transpose
of ``nn.Linear.weight``, and flax ``LayerNorm`` uses eps = 1e-6.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm default


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Plain logistic sigmoid 1 / (1 + e^-x), rounded as the JAX package's
    (``torch.sigmoid`` rounds differently)."""
    return 1.0 / (1.0 + torch.exp(-x))


def scaled_sigmoid(x: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """Sigmoid rescaled to (lower, upper)."""
    return lower + (upper - lower) * sigmoid(x)


class SinusoidalEncoding(nn.Module):
    """Fourier-feature position encoding.

    Log-spaced frequencies in [1, 32]; emits [sin(f pi x), cos(f pi x)] per
    frequency, so 3 coords -> 3 * num_fourier_features * 2 features.
    """

    def __init__(self, num_fourier_features: int):
        super().__init__()
        self.num_fourier_features = num_fourier_features

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        freqs = torch.exp(
            torch.linspace(
                float(np.log(1.0)), float(np.log(32.0)), self.num_fourier_features,
                dtype=torch.float32, device=pos.device,
            )
        )
        phase = freqs[None, :, None] * np.pi * pos[:, None, :]
        enc = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)
        return enc.reshape(pos.shape[0], -1)


def _kaiming_uniform_linear(
    fan_in: int, fan_out: int, generator: Optional[torch.Generator]
) -> nn.Linear:
    """nn.Linear with He-uniform weights (fan_in, gain 2) and zero bias."""
    layer = nn.Linear(fan_in, fan_out)
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Linear + LayerNorm + ReLU stack emitting (B, G, K, P) parameters."""

    def __init__(
        self,
        in_features: int,
        num_hidden_layers: int,
        num_neurons: int,
        num_groups: int,
        num_biquads: int = 1,
        num_params: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.out_shape = (num_groups, num_biquads, num_params)
        widths = [in_features] + [num_neurons] * (num_hidden_layers + 1)
        out = num_groups * num_biquads * num_params
        self.dense = nn.ModuleList(
            [_kaiming_uniform_linear(a, b, generator) for a, b in zip(widths[:-1], widths[1:])]
            + [_kaiming_uniform_linear(num_neurons, out, generator)]
        )
        self.norm = nn.ModuleList(
            [nn.LayerNorm(num_neurons, eps=LAYER_NORM_EPS) for _ in widths[1:]]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for dense, norm in zip(self.dense[:-1], self.norm):
            h = torch.relu(norm(dense(h)))
        return self.dense[-1](h).reshape(x.shape[0], *self.out_shape)


class ResidualBlock(nn.Module):
    """Linear + LayerNorm + ReLU with an additive skip (width kept)."""

    def __init__(self, num_neurons: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList([_kaiming_uniform_linear(num_neurons, num_neurons, generator)])
        self.norm = nn.ModuleList([nn.LayerNorm(num_neurons, eps=LAYER_NORM_EPS)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm[0](self.dense[0](x))) + x


class MLPSkipConnections(nn.Module):
    """ResNet-style MLP emitting (B, G, K, P): an input layer, then
    ``num_hidden_layers`` residual blocks, then the output layer."""

    def __init__(
        self,
        in_features: int,
        num_hidden_layers: int,
        num_neurons: int,
        num_groups: int,
        num_biquads: int = 1,
        num_params: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.out_shape = (num_groups, num_biquads, num_params)
        first = _kaiming_uniform_linear(in_features, num_neurons, generator)
        self.norm = nn.ModuleList([nn.LayerNorm(num_neurons, eps=LAYER_NORM_EPS)])
        self.blocks = nn.ModuleList(
            [ResidualBlock(num_neurons, generator) for _ in range(num_hidden_layers)]
        )
        out = num_groups * num_biquads * num_params
        self.dense = nn.ModuleList([first, _kaiming_uniform_linear(num_neurons, out, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.norm[0](self.dense[0](x)))
        for block in self.blocks:
            h = block(h)
        return self.dense[1](h).reshape(x.shape[0], *self.out_shape)
