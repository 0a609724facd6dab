"""The yardstick of work of the directional cell: the operations of a
training step and of a validation batch of the directional (SH-domain)
model, counted from the configuration's shapes, the same whatever computes
them, and the hand-written kernels' launches at its shapes (B1, B2 on the
sub-FDNs' 9 x 9 blocks at the bins above DC, B5, B6 on the loop's at every
bin), whose bytes and operations are ``costs.COSTS``'.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .costs import cinv_cost, fft_flops, lu_cost, lut_apply_cost, neg_ptgpt_cost


@dataclass
class Shapes:
    """The sizes a directional step depends on."""

    batch: int
    nfft: int
    groups: int
    channels: int  # SH channels, the delay lines of a group
    directions: int
    slopes: int
    edc_len: int
    mlp_in: int
    width: int
    blocks: int  # residual blocks
    colorless: bool
    params: int

    @property
    def bins(self) -> int:
        return self.nfft // 2 + 1


def shapes_of(cfg: dict, decay_times, directions: int, params: int) -> Shapes:
    """The :class:`Shapes` of a configuration file's ``preset`` over the grid's
    decay times (its nfft follows them) and ``directions``."""
    fs = float(cfg["sample_rate"])
    t60 = float(np.max(decay_times))
    nfft = 2 ** int(math.ceil(math.log2(t60 * fs)))
    mixing = int(20e-3 * fs)
    out = cfg["output_filter_config"]
    return Shapes(batch=int(cfg["trainer_config"]["batch_size"]), nfft=nfft,
                  groups=int(cfg["num_groups"]), channels=(int(cfg["ambi_order"]) + 1) ** 2,
                  directions=directions, slopes=int(np.asarray(decay_times).size),
                  edc_len=min(int(t60 * 1e3 * 1e-3 * fs) + mixing, nfft) - mixing,
                  mlp_in=6 * int(out["num_fourier_features"]),
                  width=int(out["num_neurons_per_layer"]), blocks=int(out["num_hidden_layers"]),
                  colorless=bool(cfg["trainer_config"].get("use_colorless_loss", False)),
                  params=params)


def sub_outputs_flops(s: Shapes) -> float:
    """The lossless sub-FDNs' outputs c^T P b from their inverse, at the bins above DC."""
    g, f, n = s.groups, s.bins - 1, s.channels
    return 8 * g * f * n * n + 8 * g * f * n + 10 * g * f


def forward_flops(s: Shapes, batch: int) -> Dict[str, float]:
    """Operations of one forward pass of ``batch`` receivers with its losses, by part."""
    f, g, n, t = s.bins, s.groups, s.channels, s.edc_len
    w, out = s.width, g * n
    mlp = 2 * batch * s.mlp_in * w + 10 * batch * w  # the input layer, LayerNorm and ReLU
    mlp += s.blocks * (2 * batch * w * w + 11 * batch * w)  # residual blocks
    mlp += 2 * batch * w * out + 5 * batch * out  # the output layer, the unit norm, the gains
    parts = {"mlp": mlp,
             "loop": g * f * n * 42,  # z^d, its scaling by the absorption gains, the blocks
             "drive": lu_cost(g * f, n)[1],
             "mix": 8 * batch * n * f * g + 6 * batch * n * f,  # the SH mix and the band
             "irfft": fft_flops(s.nfft, batch * n),
             "analysis": 2 * batch * s.directions * n * t,
             # the EDC (square, scan, dB) and its target (amplitudes x envelopes, dB),
             # the |difference| under the mask and its sum
             "edc": batch * s.directions * t * (2 * s.slopes + 16)}
    if s.colorless:
        parts["colorless"] = cinv_cost(g * (f - 1), n)[1] + sub_outputs_flops(s)
    return parts


def train_step_flops(s: Shapes) -> float:
    """A training step: the normalization from the step's sub-FDN inverse,
    the forward with its losses, its backward (twice the forward of every
    part with a gradient, the input layer's input taking none, the EDC's
    target none; the kernels' backward costs) and Adam (12 operations a
    parameter)."""
    fwd = forward_flops(s, s.batch)
    t, f, g, n = s.edc_len, s.bins, s.groups, s.channels
    bwd = 2 * fwd["mlp"] - 2 * s.batch * s.mlp_in * s.width
    bwd += 2 * (fwd["loop"] + fwd["mix"] + fwd["irfft"] + fwd["analysis"])
    bwd += 2 * s.batch * s.directions * t * 8  # the EDC's own part
    bwd += lut_apply_cost(g * f, n)[1]
    if s.colorless:
        bwd += neg_ptgpt_cost(g * (f - 1), n)[1] + 2 * sub_outputs_flops(s)
    norm = sub_outputs_flops(s) if s.colorless else \
        cinv_cost(g * (f - 1), n)[1] + sub_outputs_flops(s)
    return sum(fwd.values()) + bwd + 12 * s.params + norm


def launches(s: Shapes) -> Dict[str, List[Tuple[str, tuple]]]:
    """The hand-written kernels' launches and their shapes: a step, a
    validation batch (each size alike)."""
    g, f, n = s.groups, s.bins, s.channels
    sub, loop = (g * (f - 1), n), (g * f, n)
    valid = [("lu", loop)] + ([("cinv", sub)] if s.colorless else [])
    step = [("cinv", sub), ("lu", loop), ("lut_apply", loop)] + \
        ([("neg_ptgpt", sub)] if s.colorless else [])
    return {"step": step, "valid": valid}
