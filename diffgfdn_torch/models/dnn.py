"""DNN building blocks (port of ``diffgfdn_tpu/models/dnn.py``: sigmoids,
MLPs, the encoding, the floor-plan CNN).

Layer order, initializers and LayerNorm epsilon follow the flax modules so
that parameters carried over from the JAX package (``utils/params.py``)
give the same function: a flax ``Dense.kernel`` (in, out) is the transpose
of ``nn.Linear.weight``, a flax ``Conv.kernel`` (kh, kw, in, out) is
``nn.Conv2d.weight`` (out, in, kh, kw) permuted, and flax ``LayerNorm`` uses
eps = 1e-6.
"""

import math
from typing import Optional, Sequence, Tuple

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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), always positive (as the JAX package writes it)."""
    return torch.log1p(torch.exp(x))


def scaled_softplus(x: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """Softplus squashed into (lower, upper)."""
    sp = softplus(x)
    return lower + (upper - lower) * sp / (1.0 + sp)


def tan_sigmoid(x: torch.Tensor, scale_factor: float = 1.0) -> torch.Tensor:
    """tan(pi / 2 * sigmoid(x)): positive, unbounded above."""
    return torch.tan(np.pi * sigmoid(scale_factor * x) * 0.5)


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


def one_hot_mesh_encoding(
    mesh_2d: torch.Tensor, receiver_pos: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-hot receiver encoding over the floor-plan meshgrid.

    ``mesh_2d``: (L, 2) flattened (x, y) mesh; ``receiver_pos``: (B, >= 2).
    Returns (input (L, 3) float32: each point's x, y and a 1 where it is the
    point nearest some receiver; the closest points (B, 2); their indices
    (B,), the first nearest point on a tie).
    """
    d2 = ((mesh_2d[None, :, 0] - receiver_pos[:, None, 0]) ** 2
          + (mesh_2d[None, :, 1] - receiver_pos[:, None, 1]) ** 2)
    rec_idx = torch.argmin(d2, dim=1)
    one_hot = torch.zeros(mesh_2d.shape[0], dtype=mesh_2d.dtype, device=mesh_2d.device)
    one_hot = one_hot.index_fill(0, rec_idx, 1.0)
    inp = torch.cat([mesh_2d[:, :2], one_hot[:, None]], dim=1)
    return inp.to(torch.float32), mesh_2d[rec_idx, :2], rec_idx


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


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1 / fan_in
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def _lecun_normal_conv(
    in_channels: int, out_channels: int, kernel_size: Sequence[int],
    generator: Optional[torch.Generator],
) -> nn.Conv2d:
    """nn.Conv2d with "SAME" padding, LeCun-normal (truncated) weights and
    zero bias, as flax ``nn.Conv``'s defaults."""
    layer = nn.Conv2d(in_channels, out_channels, tuple(kernel_size), padding="same")
    std = math.sqrt(1.0 / (in_channels * math.prod(kernel_size))) / _TRUNCATED_NORMAL_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class ConvNet(nn.Module):
    """2-D CNN over the floor-plan grid: ``num_layers`` convolutions ("SAME"
    padding) with ReLU between them.

    Input (H, W, in_channels), output (H, W, num_groups, out_channels),
    channels last as the flax module; the convolutions run NCHW on a batch
    of one, permuted at the module's edges.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_groups: int,
        hidden_channels: int,
        num_layers: int = 3,
        kernel_size: Sequence[int] = (3, 3),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.out_shape = (num_groups, out_channels)
        widths = [in_channels] + [hidden_channels] * (num_layers - 1) + [num_groups * out_channels]
        self.conv = nn.ModuleList([
            _lecun_normal_conv(a, b, kernel_size, generator)
            for a, b in zip(widths[:-1], widths[1:])
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(2, 0, 1)[None]  # (1, C, H, W)
        for conv in self.conv[:-1]:
            h = torch.relu(conv(h))
        h = self.conv[-1](h)[0].permute(1, 2, 0)  # (H, W, G * O)
        return h.reshape(x.shape[0], x.shape[1], *self.out_shape)
