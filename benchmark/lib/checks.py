"""What decides ``correct``: the program's outputs against the plain
reference (``benchmark/reference``), each number held to its limit.

The reference computes in the configuration's float32, as the program does,
except the io-gain normalization (below), which it computes in float64 from
the same float32 state; the control (``benchmark/control.py``) is the same
reference with TF32 products. In float32 some of the model's values are set
by the formulation's rounding, which two float32 implementations share and
float64 does not (PERF.md: the SVF low shelf's damping, 2 r f, falls below
the rounding of its a0 when the resonance r nears its floor), so a float64
reference would read that and not the program. It follows the first three
steps from the same weights,
batches and EDC masks (the forward, the losses, autograd and Adam) and gives
each step's losses, each leaf's first gradient and each leaf's change after
the three steps. A cell compares the numbers its
``benchmark/limits/<cell>.json`` names; the others are read by
``benchmark/control.py`` when limits are set:

* ``fit_loss_gap``: the largest |L - L_ref| / |L_ref| of the three steps'
  data losses (EDC and EDR); ``loss_gap`` of their total losses;
  ``spectral_gap`` and ``sparsity_gap`` of the colorless loss's two terms,
  ``spectral_gap_first`` of the first step's spectral term alone;
* ``grad_gap``: the largest gap between the norms of a leaf's first
  gradient, as the optimizer got it (Adam's first moment after one step over
  1 - beta1), over the larger of the reference leaf's norm and the median
  leaf's; ``grad_gap_median`` the median leaf's gap; ``grad_gap_heads`` the
  worst of the leaves that the colorless loss does not reach (its gradient
  of them is none in the reference), ``grad_gap_loop`` of those it reaches;
* ``change_gap``: the same of each leaf's change after three steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a gradient nought to rounding moves a leaf under Adam by
  round-off alone); ``change_gap_median`` the median leaf's gap;
* ``norm_gap``: the io-gain normalization alone. The program's scale of each
  group at each normalization the three steps hold (its gains before over
  its gains after) against the reference's scale of the same state (the
  program's M, b and c just before). The normalization divides b and c by
  the lossless sub-FDNs' mean energy, which their bins nearest a mode
  dominate, so it magnifies rounding: followed through the steps, the
  reference's own scales put more into every later number than the control
  does (PERF.md), so the steps take the program's normalized gains and the
  normalization is held here;
* ``valid_loss_gap``: the relative gap of the first validation batch's data
  losses, at the parameters the program had after its first epoch.
"""

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..reference import gfdn as ref
from .data import Grid

ADAM_BETA1 = 0.9
MIN_GRAD_SHARE = 1e-3  # leaves whose reference gradient is below this share of the median's
COLORLESS_TERMS = ("spectral_loss", "sparsity_loss")
DATA_TERMS = ("edc_loss", "edr_loss")
IO_GAINS = ("input_gains", "output_gains")
LOOP_STATE = ("feedback_loop.M",) + IO_GAINS


def leaf_gaps(prog: Dict[str, float], refs: Dict[str, float], keys=None) -> Dict[str, float]:
    """{leaf: |prog - ref| / max(ref, median ref)} of each leaf's norm."""
    keys = sorted(refs) if keys is None else keys
    med = float(np.median([refs[k] for k in refs]))
    return {k: abs(prog[k] - refs[k]) / max(refs[k], med, 1e-30) for k in keys}


def program_scales(before: torch.Tensor, after: torch.Tensor, groups: int) -> np.ndarray:
    """Each group's normalization scale, from the gains before and after it."""
    return (before / after).reshape(groups, -1).mean(dim=1).double().cpu().numpy()


def reference_scales(cfg: dict, grid: Grid, states: List[Dict[str, torch.Tensor]], device,
                     dtype=torch.float64) -> List[np.ndarray]:
    """The reference's normalization scales (G,) of each state {M, b, c}."""
    model = ref.GridGFDN(cfg, grid.decay_times, grid.band_hz, device, dtype)
    z = ref.z_values(int(cfg["trainer_config"]["num_freq_bins"]), device)
    return [model.norm_scales({k: v.to(device, dtype) for k, v in st.items()}, z)
            .double().cpu().numpy() for st in states]


class ReferenceTraining:
    """The reference's first ``len(batches)`` steps of a grid model."""

    def __init__(self, cfg: dict, grid: Grid, weights: Dict[str, torch.Tensor],
                 batches: List[np.ndarray], mask_seed: int, device,
                 dtype=torch.float32, keep: Optional[float] = None, frozen: bool = False,
                 follow: Optional[List[Optional[Dict[str, torch.Tensor]]]] = None):
        self.cfg, self.grid, self.device, self.dtype = cfg, grid, device, dtype
        self.weights = {k: v.detach().to(device) for k, v in weights.items()}
        self.batches = batches
        self.mask_seed = mask_seed
        # planted faults: a share of each batch kept; every step leaving the state unchanged
        self.keep, self.frozen = keep, frozen
        # io gains to take at each normalization instead of normalizing (None: normalize)
        self.follow = follow

    def run(self) -> dict:
        cfg, grid, dev, dt = self.cfg, self.grid, self.device, self.dtype
        model = ref.GridGFDN(cfg, grid.decay_times, grid.band_hz, dev, dt)
        sizes = ref.Sizes(cfg, grid.decay_times)
        z = ref.z_values(sizes.nfft, dev)
        pos = torch.as_tensor(grid.receivers, device=dev).to(dt)
        norm_pos = torch.as_tensor(grid.norm_receivers, device=dev).to(dt)
        p = {k: v.to(dt).clone().requires_grad_(True) for k, v in self.weights.items()}
        opt = ref.Adam(cfg, p)
        tc = cfg["trainer_config"]
        gen = torch.Generator(device=dev).manual_seed(self.mask_seed % 2 ** 63)
        out = {"parts": [], "losses": [], "fit_losses": [], "normalized": [], "scales": []}
        total_bytes = grid.rirs.nbytes
        for k, idx in enumerate(self.batches):
            idx = np.asarray(idx)
            if self.keep is not None:
                idx = idx[: max(1, int(len(idx) * self.keep))]
            # SVF heads normalize once an epoch, before its first step; scalar
            # heads before every step
            out["normalized"].append(None)
            if k == 0 or not model.svf:
                follow = None if self.follow is None else self.follow[k]
                with torch.no_grad():
                    if follow is None:
                        out["scales"].append(model.normalize(p, z).double().cpu().numpy())
                    else:
                        for n in IO_GAINS:
                            p[n].copy_(follow[n])
                out["normalized"][k] = {n: p[n].detach().float().clone() for n in IO_GAINS}
            mask = ref.edc_mask(sizes.edc_end - sizes.mixing, gen, dev).to(dt) \
                if tc.get("use_edc_mask", False) else None
            early = torch.fft.rfft(torch.as_tensor(
                ref.early_segment(grid.rirs[idx], grid.fs), device=dev).to(dt), n=sizes.nfft,
                dim=-1)
            target = ref.target_features(ref.coded_targets(grid.rirs[idx], total_bytes),
                                         sizes, dev, dt)
            h = model.response(p, z, pos[idx], norm_pos[idx], early)
            parts = ref.omni_losses(model, p, h, target, sizes, mask, z)
            total = sum(parts.values())
            if k == 0:
                colorless = [parts[t] for t in COLORLESS_TERMS if t in parts]
                reach = torch.autograd.grad(sum(colorless), list(p.values()), retain_graph=True,
                                            allow_unused=True) if colorless else [None] * len(p)
                out["reached"] = sorted(n for n, g in zip(p, reach) if g is not None)
            grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
            out["parts"].append({n: float(v.detach()) for n, v in parts.items()})
            out["losses"].append(float(total.detach()))
            out["fit_losses"].append(sum(out["parts"][-1][t] for t in DATA_TERMS))
            if k == 0:
                out["grad_norms"] = {n: float(torch.linalg.vector_norm(g))
                                     for n, g in grads.items()}
            if not self.frozen:
                opt.step(p, grads)
        out["change_norms"] = {n: float(torch.linalg.vector_norm(p[n].detach() - self.weights[n]))
                               for n in p}
        return out


def reference_valid_loss(cfg: dict, grid: Grid, readings: dict, mask_seed: int, device,
                         keep: Optional[float] = None, dtype=torch.float32) -> float:
    """The data losses (EDC and EDR) of the first validation batch, at the
    parameters the program computed it with (its state at the end of its
    first epoch: the steps before it are the graph the three steps check)."""
    model = ref.GridGFDN(cfg, grid.decay_times, grid.band_hz, device, dtype)
    sizes = ref.Sizes(cfg, grid.decay_times)
    z = ref.z_values(sizes.nfft, device)
    idx = np.asarray(readings["valid_batch"])
    if keep is not None:
        idx = idx[: max(1, int(len(idx) * keep))]
    mask = None
    if cfg["trainer_config"].get("use_edc_mask", False):
        gen = torch.Generator(device=device).manual_seed(mask_seed % 2 ** 63)
        for _ in range(readings["valid_masks_before"] + 1):
            mask = ref.edc_mask(sizes.edc_end - sizes.mixing, gen, device)
        mask = mask.to(dtype)
    p = {k: v.detach().to(device, dtype) for k, v in readings["valid_params"].items()}
    with torch.no_grad():
        early = torch.fft.rfft(torch.as_tensor(ref.early_segment(grid.rirs[idx], grid.fs),
                                               device=device).to(dtype), n=sizes.nfft, dim=-1)
        target = ref.target_features(ref.coded_targets(grid.rirs[idx], grid.rirs.nbytes),
                                     sizes, device, dtype)
        pos = torch.as_tensor(grid.receivers[idx], device=device).to(dtype)
        norm_pos = torch.as_tensor(grid.norm_receivers[idx], device=device).to(dtype)
        h = model.response(p, z, pos, norm_pos, early)
        parts = ref.omni_losses(model, p, h, target, sizes, mask, z)
    return float(sum(parts[t] for t in DATA_TERMS))


def training_numbers(prog: dict, reference: dict) -> Dict[str, float]:
    """Every number of a training cell, the program's readings (or a
    stand-in's) against the reference's."""
    def gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    out = {"loss_gap": gap(prog["losses"], reference["losses"]),
           "fit_loss_gap": gap(prog["fit_losses"], reference["fit_losses"])}
    for term, name in (("spectral_loss", "spectral_gap"), ("sparsity_loss", "sparsity_gap")):
        if term in reference["parts"][0] and term in prog["parts"][0]:
            mine = [p[term] for p in prog["parts"]]
            theirs = [p[term] for p in reference["parts"]]
            out[name] = gap(mine, theirs)
            if term == "spectral_loss":
                out["spectral_gap_first"] = gap(mine[:1], theirs[:1])
    g_ref = reference["grad_norms"]
    grads = leaf_gaps(prog["grad_norms"], g_ref)
    out["grad_gap"] = max(grads.values())
    out["grad_gap_median"] = float(np.median(list(grads.values())))
    heads = [v for k, v in grads.items() if k not in reference["reached"]]
    loop = [v for k, v in grads.items() if k in reference["reached"]]
    if heads:
        out["grad_gap_heads"] = max(heads)
    if loop:
        out["grad_gap_loop"] = max(loop)
    med = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= MIN_GRAD_SHARE * med]
    changes = leaf_gaps(prog["change_norms"], reference["change_norms"], moved)
    out["change_gap"] = max(changes.values())
    out["change_gap_median"] = float(np.median(list(changes.values())))
    if prog.get("scales") and reference.get("scales"):
        out["norm_gap"] = float(max(np.max(np.abs(a - b) / b)
                                    for a, b in zip(prog["scales"], reference["scales"])))
    if "valid_loss" in reference and "valid_loss" in prog:
        out["valid_loss_gap"] = abs(prog["valid_loss"] - reference["valid_loss"]) / abs(
            reference["valid_loss"])
    return out


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[tuple]]:
    """(every number within its limit, [(name, value, limit)]); a number that
    is not finite fails."""
    rows = [(name, numbers.get(name, math.nan), limits[name]) for name in sorted(limits)]
    return all(math.isfinite(v) and v <= lim for _, v, lim in rows), rows
