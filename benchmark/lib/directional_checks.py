"""What decides ``correct`` for the directional trainer: the plain reference
(``benchmark/reference/directional.py``) follows the program's first three
steps and its first validation batch, and ``checks.training_numbers`` turns
both sides' readings into the numbers each limit holds.

As ``checks.ReferenceTraining`` for the grid model: the same weights,
batches and EDC masks (drawn from a generator seeded as the program's), the
forward, the losses, autograd and Adam in float32, the io-gain normalization
taken from the program (``follow``) and held alone against float64
(:func:`reference_scales`). The data loss is the directional EDC loss alone
(the model has no EDR); the sub-FDN terms and the normalization skip the DC
bin, as the program's (ROADMAP C10).

The loop's state is the program's before each step (``follow_m``: M, as
``follow`` gives the io gains), the heads the reference's own. M's gradient
is the colorless spectral term's, which the bins nearest the lossless modes
set to rounding, and Adam's first steps move each element by the learning
rate whatever its size: where an element's true gradient lies under the
float32 sides' error, rounding chooses its direction, and the steps after
it part. The steps' sparsity term is then compared at the same M.

The data term's share of the loop leaves' gradient is 2e-5 or less, and a
direction's error enters the steps' losses and gradients only through sums
over the directions. So the check also holds a probe (:func:`reference_probe`
against the program's, taken in set-up before the first step at the seed's
weights on the first validation batch under a mask of its own): the data
term's gradient of each loop leaf (B5 / B6 on the transposed blocks, the SH
mix), each receiver's and direction's EDC error alone, and the spectral
term's gradient of each loop leaf on the circle of radius
:data:`PROBE_RADIUS`, where every lossless mode lies a hundredth off the
contour (B1 / B2), each leaf compared as a vector.

Planted faults, for the control (``benchmark/control_directional.py``),
each a value of ``fault``: ``plain_beams`` (the analysis matrix's beams
without their order weights: the SH basis steered to each direction, scaled
as the max-directivity matrix is), ``permuted`` (the analysis matrix's rows
rolled by one direction), ``drive_grad_x2`` (the gradient through the
transposed solve doubled, as a B6 that returned twice M^-H g),
``inverse_grad_x2`` (the gradient through the sub-FDN inverse doubled, as a
B2 that returned twice its -P^H G P^H) and ``sparsity_x2`` (the sparsity
term doubled); besides a share of each batch kept (``keep``) and every step
leaving the state unchanged (``frozen``).
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import directional as ref_dir, gfdn as ref
from .checks import COLORLESS_TERMS, IO_GAINS, LOOP_STATE
from .spatial_grid import SpatialGrid

DATA_TERMS = ("edc_loss",)
PROBE_RADIUS = 1.01  # |z| of the colorless probe
FAULTS = ("plain_beams", "permuted", "drive_grad_x2", "inverse_grad_x2", "sparsity_x2")


def _grad_times(x: torch.Tensor, k: float) -> torch.Tensor:
    """x, its gradient times k."""
    return x * k - x.detach() * (k - 1.0)


def model_of(cfg: dict, grid: SpatialGrid, device, dtype=torch.float32,
             fault: Optional[str] = None) -> ref_dir.DirectionalGFDN:
    """The reference model, with one of :data:`FAULTS` planted when given."""
    model = ref_dir.DirectionalGFDN(cfg, grid.decay_times, grid.directions, device, dtype)
    if fault == "plain_beams":
        model.analysis = torch.as_tensor(ref_dir.analysis_matrix(grid.directions, (1.0, 1.0, 1.0)),
                                         device=device).to(dtype)
    elif fault == "permuted":
        model.analysis = torch.roll(model.analysis, 1, dims=0)
    elif fault == "drive_grad_x2":
        drive = model.drive
        model.drive = lambda p, z: _grad_times(drive(p, z), 2.0)
    elif fault == "inverse_grad_x2":
        inverse = model.loop.sub_inverse
        model.loop.sub_inverse = lambda p, z: _grad_times(inverse(p, z), 2.0)
    elif fault == "sparsity_x2":
        colorless = model.colorless_losses

        def doubled(p, z_sub):
            out = colorless(p, z_sub)
            out["sparsity_loss"] = 2.0 * out["sparsity_loss"]
            return out
        model.colorless_losses = doubled
    elif fault is not None:
        raise ValueError(f"no fault named {fault}")
    return model


def sub_bins(model: ref_dir.DirectionalGFDN, device) -> tuple:
    """(all rFFT bins, the sub-FDNs' bins: all but DC)."""
    z = ref.z_values(model.nfft, device)
    return z, z[1:]


def reference_scales(cfg: dict, grid: SpatialGrid, states: List[Dict[str, torch.Tensor]],
                     device, dtype=torch.float64) -> List[np.ndarray]:
    """The reference's normalization scales (G,) of each state {M, b, c}."""
    model = model_of(cfg, grid, device, dtype)
    _, z_sub = sub_bins(model, device)
    return [model.norm_scales({k: v.to(device, dtype) for k, v in st.items()}, z_sub)
            .double().cpu().numpy() for st in states]


class DirectionalTraining:
    """The reference's first ``len(batches)`` steps of the directional model."""

    def __init__(self, cfg: dict, grid: SpatialGrid, weights: Dict[str, torch.Tensor],
                 batches: List[np.ndarray], mask_seed: int, device,
                 dtype=torch.float32, keep: Optional[float] = None, frozen: bool = False,
                 fault: Optional[str] = None,
                 follow: Optional[List[Optional[Dict[str, torch.Tensor]]]] = None,
                 follow_m: Optional[List[torch.Tensor]] = None):
        self.cfg, self.grid, self.device, self.dtype = cfg, grid, device, dtype
        self.weights = {k: v.detach().to(device) for k, v in weights.items()}
        self.batches = batches
        self.mask_seed = mask_seed
        self.keep, self.frozen, self.fault = keep, frozen, fault
        # io gains to take at each normalization instead of normalizing (None: normalize)
        self.follow = follow
        # M to take before each step (the program's), or None: the reference's own
        self.follow_m = follow_m

    def run(self) -> dict:
        dev, dt = self.device, self.dtype
        model = model_of(self.cfg, self.grid, dev, dt, self.fault)
        z, z_sub = sub_bins(model, dev)
        norm_pos = torch.as_tensor(self.grid.norm_receivers, device=dev).to(dt)
        amps = torch.as_tensor(self.grid.amplitudes, device=dev).to(dt)
        p = {k: v.to(dt).clone().requires_grad_(True) for k, v in self.weights.items()}
        opt = ref.Adam(self.cfg, p)
        gen = torch.Generator(device=dev).manual_seed(self.mask_seed % 2 ** 63)
        out = {"parts": [], "losses": [], "fit_losses": [], "normalized": [], "scales": []}
        for k, idx in enumerate(self.batches):
            idx = np.asarray(idx)
            if self.keep is not None:
                idx = idx[: max(1, int(len(idx) * self.keep))]
            follow = None if self.follow is None else self.follow[k]
            with torch.no_grad():  # frequency-independent heads: before every step
                if follow is None:
                    out["scales"].append(model.normalize(p, z_sub).double().cpu().numpy())
                else:
                    for n in IO_GAINS:
                        p[n].copy_(follow[n])
                if self.follow_m is not None:
                    p["feedback_loop.M"].copy_(self.follow_m[k])
            out["normalized"].append({n: p[n].detach().float().clone() for n in IO_GAINS})
            mask = ref.edc_mask(model.edc_len, gen, dev).to(dt) \
                if self.cfg["trainer_config"].get("use_edc_mask", False) else None
            h = model.response(p, z, norm_pos[idx])
            parts = model.losses(p, h, amps[idx], mask, z_sub)
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


def reference_valid_loss(cfg: dict, grid: SpatialGrid, readings: dict, mask_seed: int, device,
                         keep: Optional[float] = None, dtype=torch.float32,
                         fault: Optional[str] = None) -> float:
    """The directional EDC loss of the first validation batch, at the
    parameters the program computed it with, under the EDC mask its
    validation step drew (the epoch's steps drew ``valid_masks_before``)."""
    model = model_of(cfg, grid, device, dtype, fault)
    z, z_sub = sub_bins(model, device)
    idx = np.asarray(readings["valid_batch"])
    if keep is not None:
        idx = idx[: max(1, int(len(idx) * keep))]
    mask = None
    if cfg["trainer_config"].get("use_edc_mask", False):
        gen = torch.Generator(device=device).manual_seed(mask_seed % 2 ** 63)
        for _ in range(readings["valid_masks_before"] + 1):
            mask = ref.edc_mask(model.edc_len, gen, device)
        mask = mask.to(dtype)
    p = {k: v.detach().to(device, dtype) for k, v in readings["valid_params"].items()}
    with torch.no_grad():
        norm_pos = torch.as_tensor(grid.norm_receivers[idx], device=device).to(dtype)
        amps = torch.as_tensor(grid.amplitudes[idx], device=device).to(dtype)
        parts = model.losses(p, model.response(p, z, norm_pos), amps, mask, z_sub)
    return float(sum(parts[t] for t in DATA_TERMS))


def probe_mask(length: int, seed: int, device) -> torch.Tensor:
    """The probe's EDC mask, from a generator of its own (the steps' masks
    are the trainer's)."""
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2 ** 63)
    return ref.edc_mask(length, gen, device)


def reference_probe(cfg: dict, grid: SpatialGrid, weights: Dict[str, torch.Tensor],
                    idx: np.ndarray, mask: torch.Tensor, device, dtype=torch.float32,
                    keep: Optional[float] = None, fault: Optional[str] = None) -> dict:
    """The reference's side of the probe at ``weights`` on the receivers
    ``idx`` under the EDC ``mask``: {"data_grads", "spectral_grads": {leaf:
    gradient}, "directions": [[each receiver's and direction's EDC error]]}."""
    model = model_of(cfg, grid, device, dtype, fault)
    z, z_sub = sub_bins(model, device)
    idx = np.asarray(idx)
    if keep is not None:
        idx = idx[: max(1, int(len(idx) * keep))]
    p = {k: v.detach().to(device, dtype).clone().requires_grad_(True) for k, v in weights.items()}
    leaves = [p[n] for n in LOOP_STATE]
    norm_pos = torch.as_tensor(grid.norm_receivers[idx], device=device).to(dtype)
    amps = torch.as_tensor(grid.amplitudes[idx], device=device).to(dtype)
    mask = mask.to(device, dtype)
    h = model.response(p, z, norm_pos)
    data = torch.autograd.grad(model.losses(p, h, amps, mask, z_sub)["edc_loss"], leaves)
    with torch.no_grad():
        directions = [[float(model.edc_error(h[b:b + 1], amps[b:b + 1, j:j + 1], mask,
                                             model.analysis[j:j + 1]))
                       for j in range(model.analysis.shape[0])] for b in range(len(idx))]
    spectral = torch.autograd.grad(
        model.colorless_losses(p, z_sub * PROBE_RADIUS)["spectral_loss"], leaves)
    return {"data_grads": {n: g.detach().double().cpu() for n, g in zip(LOOP_STATE, data)},
            "spectral_grads": {n: g.detach().double().cpu() for n, g in zip(LOOP_STATE, spectral)},
            "directions": directions}


def probe_numbers(prog: dict, reference: dict) -> Dict[str, float]:
    """The probe's numbers: the worst loop leaf's gradient, data and
    spectral terms apart, |g - g_ref| / |g_ref| as vectors, and the worst
    receiver's and direction's |error - error_ref| / error_ref."""
    def worst(key):
        return max(float(torch.linalg.vector_norm(prog[key][n].double() - g)
                         / torch.linalg.vector_norm(g)) for n, g in reference[key].items())

    return {"probe_data_grad_gap": worst("data_grads"),
            "probe_spectral_grad_gap": worst("spectral_grads"),
            "direction_gap": max(abs(a - b) / abs(b) for pa, ra in
                                 zip(prog["directions"], reference["directions"])
                                 for a, b in zip(pa, ra))}


def program_m(readings: dict) -> List[torch.Tensor]:
    """The program's M before each of the steps the reference follows."""
    return [st["feedback_loop.M"] for st in readings["norm_states"]]
