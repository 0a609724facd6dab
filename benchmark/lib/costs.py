"""The yardstick of work: the H100's published peaks, each hand-written
kernel's bytes and operations at its launch shape, and the operations of a
training step and of a validation batch counted from the
configuration's shapes, the same whatever computes them.

The kernel costs are frozen copies of ``chip_smoke.py``'s (``cinv_cost``,
``lu_cost``, ``sos_cost``, ``neg_ptgpt_cost``, ``lut_apply_cost``,
``sos_backward_saved_h_cost``, here ``sos_backward_cost``): each input byte read once, each output byte written
once, and the fp32 operations of the algorithm.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores (TF32 is off)

# device symbol of the kernel each counted wrapper launches, and the prefix
# of every kernel of that wrapper's family (B4 runs in two passes)
WRAPPER_SYMBOLS = {"cinv": "cinv_kernel", "neg_ptgpt": "neg_ptgpt_kernel",
                   "sos": "sos_cascade_kernel", "sos_backward": "sos_bwd_partial_kernel",
                   "lu": "lu_solve_kernel", "lut_apply": "lut_apply_kernel"}
FAMILY_PREFIX = {"cinv": "cinv_kernel", "neg_ptgpt": "neg_ptgpt_kernel",
                 "sos": "sos_cascade_kernel", "sos_backward": "sos_bwd_",
                 "lu": "lu_solve_kernel", "lut_apply": "lut_apply_kernel"}


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time (ms) of a call: bytes over the HBM rate or operations
    over the fp32 rate, whichever is larger, and which."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cinv_cost(k: int, n: int):
    """Bytes and operations of the Gauss-Jordan inverse of k complex n x n systems."""
    flops = 0
    for s in range(n):
        w = 2 * n - s  # active columns of the augmented system
        flops += 3 * (n - s) + 4 + 6 * w + 8 * (n - 1) * w
    return 2 * k * n * n * 8, k * flops


def lu_cost(k: int, n: int):
    """Bytes and operations of the LU solve (x, factors and pivots out)."""
    flops = 0
    for s in range(n):
        a = n - s - 1  # rows (and columns) below / right of the pivot
        flops += 3 * (n - s) + (4 + a * (6 + 8 * a + 8) if a else 0)
        flops += 8 * a + 8  # back substitution of row s
    nbytes = k * (n * n * 8 + n * 8) + k * (n * 8 + n * n * 8 + n * 4)
    return nbytes, k * flops


def sos_cost(r: int, k: int, f: int):
    """Bytes and operations of r cascades of k biquads at f points."""
    return r * f * 8 + f * 8 + 2 * r * k * 3 * 4, r * f * (32 * k + 3)


def neg_ptgpt_cost(k: int, n: int):
    """Bytes and operations of -P^H G P^H (two n^3 complex contractions)."""
    return 3 * k * n * n * 8, k * 16 * n ** 3


def lut_apply_cost(k: int, n: int):
    """Bytes and operations of the transposed solve from the LU factors."""
    nbytes = k * (n * n * 8 + n * 4 + 2 * n * 8)
    return nbytes, k * (12 * n + 8 * n * (n - 1) + 2 * (n - 1))


def sos_backward_cost(r: int, k: int, f: int):
    """Bytes and operations of the cascade backward, which reads the forward's
    h (G and h read; the 6k sums a row without h's recompute)."""
    return 2 * r * f * 8 + f * 8 + 4 * r * k * 3 * 4, r * f * ((91 * k + 11) - (32 * k + 3))


COSTS = {"cinv": cinv_cost, "neg_ptgpt": neg_ptgpt_cost, "sos": sos_cost,
         "sos_backward": sos_backward_cost, "lu": lu_cost, "lut_apply": lut_apply_cost}


@dataclass
class Shapes:
    """The sizes a grid model's step depends on."""

    batch: int
    nfft: int
    groups: int
    lines: int
    svf: bool
    head_sections: int
    absorption_sections: int  # 0: scalar absorption gains
    mlp_widths: List[int]  # input, hidden..., output
    colorless: bool
    edc_len: int
    edr_win: int
    edr_frames: int
    params: int

    @property
    def bins(self) -> int:
        return self.nfft // 2 + 1

    @property
    def per_group(self) -> int:
        return self.lines // self.groups


def shapes_of(cfg: dict, decay_times, params: int, batch: Optional[int] = None) -> Shapes:
    """The :class:`Shapes` of a configuration file's ``preset`` with the grid's
    decay times, its model having ``params`` parameters."""
    import numpy as np

    fs = float(cfg["sample_rate"])
    tc = cfg["trainer_config"]
    head = cfg.get("output_filter_config", {})
    nfft = int(tc["num_freq_bins"])
    svf = bool(head.get("use_svfs", True))
    groups = int(cfg["num_groups"])
    layers = int(head.get("num_hidden_layers", 3))
    width = int(head.get("num_neurons_per_layer", 128))
    k_head = 11  # low shelf, nine octave peaks, high shelf
    out = groups * (k_head * 2 if svf else 1)
    widths = [6 * int(head.get("num_fourier_features", 10))] + [width] * (layers + 1) + [out]
    t60 = np.asarray(decay_times)
    geq = cfg.get("decay_filter_config", {}).get("use_absorption_filters", True) \
        and t60.ndim == 2 and t60.shape[0] > 1
    mixing = int(20e-3 * fs)
    edc_end = min(int(float(t60.max()) * 1e3 * 1e-3 * fs), nfft)
    win = min(2 ** 12, 2 ** int(math.log2(max(nfft // 4, 8))))
    return Shapes(batch=int(batch or tc["batch_size"]), nfft=nfft, groups=groups,
                  lines=int(cfg["num_delay_lines"]), svf=svf, head_sections=k_head,
                  absorption_sections=(t60.shape[0] + 3) if geq else 0, mlp_widths=widths,
                  colorless=bool(tc.get("use_colorless_loss", False)),
                  edc_len=edc_end - mixing, edr_win=win,
                  edr_frames=(nfft - win) // (win // 2) + 1, params=params)


def fft_flops(n: int, count: int) -> float:
    """A real FFT of length n, count times: 2.5 n log2 n operations each."""
    return 2.5 * n * math.log2(n) * count


def forward_flops(s: Shapes, batch: int) -> Dict[str, float]:
    """Operations of one forward pass of ``batch`` receivers with its losses, by part."""
    f, g, n = s.bins, s.groups, s.per_group
    mlp = sum(2 * batch * a * b for a, b in zip(s.mlp_widths[:-1], s.mlp_widths[1:]))
    mlp += sum(10 * batch * w for w in s.mlp_widths[1:-1])  # LayerNorm and ReLU
    out = {"mlp": mlp,
           "loop": g * f * n * (40 + (11 if s.absorption_sections else 2)),  # z^d, / Gamma
           "absorption": sos_cost(s.lines, s.absorption_sections, f)[1]
           if s.absorption_sections else 0,
           "irfft": fft_flops(s.nfft, batch), "direct": 2 * batch * f}
    if s.svf:
        out["heads"] = sos_cost(batch * g, s.head_sections, f)[1]
        out["inverse"] = cinv_cost(g * f, n)[1]
        out["mix"] = 16 * g * f * n * n + 8 * batch * g * f
    else:
        out["inverse"] = lu_cost(g * f, n)[1]
        out["mix"] = 8 * batch * s.lines * f
    bins = s.edr_win // 2 + 1
    out["edc"] = 8 * batch * s.edc_len
    out["edr"] = batch * (s.edr_frames * s.edr_win + fft_flops(s.edr_win, s.edr_frames)
                          + 10 * bins * s.edr_frames)
    if s.colorless:
        out["colorless"] = cinv_cost(g * f, n)[1] + 16 * g * f * n * n + 8 * g * f
    return out


def normalize_flops(s: Shapes) -> float:
    """The io-gain normalization: each sub-FDN's inverse and output energy."""
    f, g, n = s.bins, s.groups, s.per_group
    return cinv_cost(g * f, n)[1] + 16 * g * f * n * n + 6 * g * f + g * f * n * 40


def train_step_flops(s: Shapes) -> float:
    """A training step: forward with losses, its backward (twice the forward
    of every part with a gradient, the matrix products' first input taking
    none; the kernels' backward costs), Adam (12 operations a parameter)
    and, for scalar heads, the normalization before it."""
    fwd = forward_flops(s, s.batch)
    first = 2 * s.batch * s.mlp_widths[0] * s.mlp_widths[1]
    bwd = 2 * fwd["mlp"] - first + 2 * (fwd["loop"] + fwd["irfft"] + fwd["mix"]
                                        + fwd["edc"] + fwd["edr"])
    g, f, n = s.groups, s.bins, s.per_group
    if s.svf:
        bwd += sos_backward_cost(s.batch * g, s.head_sections, f)[1]
        bwd += neg_ptgpt_cost(g * f, n)[1]
    else:
        bwd += lut_apply_cost(g * f, n)[1]
    if s.colorless:
        bwd += neg_ptgpt_cost(g * f, n)[1] + 2 * (16 * g * f * n * n + 8 * g * f)
    total = sum(fwd.values()) + bwd + 12 * s.params
    return total + (0 if s.svf else normalize_flops(s))


def train_launches(s: Shapes, valid_sizes: List[int]) -> Dict[str, List[Tuple[str, tuple]]]:
    """The hand-written kernels' launches and their shapes, by unit of a
    training epoch: a step, each validation batch size, the epoch's start."""
    g, f, n = s.groups, s.bins, s.per_group
    k = g * f

    def forward(batch):
        out = []
        if s.absorption_sections:
            out.append(("sos", (s.lines, s.absorption_sections, f)))
        if s.svf:
            out += [("sos", (batch * g, s.head_sections, f)), ("cinv", (k, n))]
        else:
            out.append(("lu", (k, n)))
        if s.colorless:
            out.append(("cinv", (k, n)))
        return out

    step = forward(s.batch)
    if s.svf:
        step += [("sos_backward", (s.batch * g, s.head_sections, f)), ("neg_ptgpt", (k, n))]
    else:
        step += [("lut_apply", (k, n)), ("cinv", (k, n))]  # B6; the normalization's B1
    if s.colorless:
        step.append(("neg_ptgpt", (k, n)))
    out = {"step": step, "epoch": [("cinv", (k, n))] if s.svf else []}
    for b in sorted(set(valid_sizes)):
        out[f"valid_{b}"] = forward(b)
    return out

