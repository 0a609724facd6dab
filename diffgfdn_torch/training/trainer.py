"""GFDN training on the device (port of ``training/trainer.py``).

:class:`GFDNTrainer` fits a grid of receivers through the
precomputed-target path of the JAX trainer, which
``run_training_var_receiver_pos`` takes:

* the dataset's time-domain RIRs and early segments are uploaded once; the
  target EDC and EDR features and the early spectra are computed on the
  device and stay there (:meth:`GFDNTrainer.precompute_target_features`,
  :meth:`GFDNTrainer.upload_arrays`);
* batches are gathered on the device from an index matrix uploaded once per
  epoch; the EDC mask is drawn on the device from a ``torch.Generator``;
* losses are summed on the device, and the host reads them once per epoch,
  when it writes the epoch's checkpoint and optimizer-state sidecar;
* with ``scan_epochs`` (the default, as in JAX) every training step and
  every full validation batch runs through a step graph
  (``training/scan.py``): on the card each is captured once in a CUDA graph
  and replayed, the host only refilling its static inputs (the batch's
  indices and the EDC mask, drawn from the generator before each step as
  the eager path draws it) and stepping the learning-rate schedule; a
  validation remainder runs eagerly, as JAX's separate ``valid_step`` does.
  ``scan_epochs = False`` runs the same step closure eagerly;
* the sub-FDN energy normalization runs under ``no_grad``, before every step
  for scalar heads and once per epoch for SVF heads, as in the JAX trainer.
  A RANDOM-coupled loop has no sub-FDNs to normalize on: ``fit_indexed``
  raises ``ValueError`` before its first step (ROADMAP C16), where the JAX
  trainer fails with an ``AttributeError``.

A subband config's trainer (``subband_filter_resp``) multiplies H by the
band filter's response before the losses, against the dataset's own
targets, as the JAX trainer does; the band-parallel trainer
(``parallel/band_parallel.py``) shares :func:`gfdn_losses` with it.

The sub-FDN terms (the per-step normalization and the colorless spectral
loss) skip the DC bin when each group has an odd number of lines (the
directional presets' 9): every orthogonal exp(skew(M)) of odd order has the
eigenvalue 1, so diag(z^m) - ortho(M) is singular at z = 1 whatever M is,
and its inverse there is set by rounding alone. The JAX trainer keeps that
bin (ROADMAP C10): its value dominates both terms, and on the card a
directional run's inverse there turned NaN within two epochs.

A directional model's trainer (:class:`DirectionalGFDNTrainer`) takes the
directional EDC loss of its SH responses against the common-slope
amplitudes times the decay envelopes: it uploads the positions and
amplitudes only, and precomputes no target feature. Where the io gains are normalized before every step and the
colorless loss is on, the step evaluates the sub-FDN inverse once for both
(it depends on M alone, not on the gains), as the JAX trainer's two
evaluations give the same values.

A single-position fit (:class:`SinglePosGFDNTrainer`) uploads its one
full-spectrum batch once and compares raw spectra each step, as JAX's
trainer does for a batch without precomputed features.

Each step's gradients run through the hand-written backward kernels: B2
(``neg_ptgpt``) behind ``block_responses`` and ``sub_fdn_output``, B4
(``sos_cascade_backward``) behind the SVF heads, B6 (``lut_apply``) behind
the scalar heads' and the directional model's ``drive``.
"""

import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config.schema import CouplingMatrixType, TrainerConfig
from ..data.audio import write_wav
from ..losses import amse_loss, directional_edc_loss_from_sh, edc_loss, edc_loss_from_rir
from ..losses import edc_mask, edr_loss, edr_loss_from_rir, frequency_weighting, mse_loss
from ..losses import reg_loss, sparsity_loss
from ..ops.basic import db, ms_to_samps, schroeder_backward_int
from ..ops.stft import edr_from_stft, erb_filterbank, stft
from ..utils.cio import upload_target_rirs
from ..utils.device import resolve_device
from ..utils.params import jax_params_from_torch, load_jax_params
from .checkpoints import (
    load_latest_checkpoint_with_epoch,
    load_opt_state,
    save_checkpoint,
    save_opt_state,
)
from .optim import load_optimizer_state, make_optimizer
from .scan import GraphedSteps

logger = logging.getLogger("diffgfdn_torch")

Batch = Dict[str, torch.Tensor]


def padded_batches(idx: np.ndarray, batch_size: int):
    """Split an index vector into full batches, padding the tail by wrapping
    around to the head (every item at least once, every batch full)."""
    n = len(idx)
    for k in range(max(1, -(-n // batch_size))):
        b = idx[k * batch_size : (k + 1) * batch_size]
        if len(b) == 0:
            return
        if len(b) < batch_size:
            b = np.concatenate([b, idx[: batch_size - len(b)]])
        yield b


def exact_valid_batches(idx: np.ndarray, batch_size: int):
    """(full batches, unpadded remainder) of a validation split: an
    item-weighted mean over them is the exact per-item mean."""
    idx = np.asarray(idx)
    n = len(idx)
    full = [idx[k * batch_size : (k + 1) * batch_size] for k in range(n // batch_size)]
    return full, idx[(n // batch_size) * batch_size :]


def gfdn_losses(
    model: torch.nn.Module,
    cfg: TrainerConfig,
    batch: Batch,
    mixing: int,
    max_len: int,
    edr_win: int,
    edr_hop: int,
    band_resp: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    envelopes: Optional[torch.Tensor] = None,
    sub_inverse: Optional[torch.Tensor] = None,
    erb_filters: Optional[torch.Tensor] = None,
    freq_weights: Optional[torch.Tensor] = None,
    reg_len: Optional[int] = None,
    shard=None,
    use_matmul_irfft: bool = False,
) -> Dict[str, torch.Tensor]:
    """The weighted losses of one batch against its precomputed target
    features (JAX ``GFDNTrainer._losses``' fast path, and the band loss of
    ``parallel/band_parallel.py``), or, for a batch without them (a
    single-position fit's), against its raw ``target_rir_response``
    (the JAX trainer's other branch): EDC from sample ``mixing`` to ``max_len``
    (with the time ``mask`` when given), EDR, and with the colorless loss the
    sub-FDNs' spectral and sparsity terms. ``band_resp`` (F,) complex, when
    given, multiplies H (subband training); the sub-FDN terms take the
    unfiltered loop at :func:`sub_fdn_bins`, through ``sub_inverse`` when
    given (the model's ``sub_fdn_inverse`` there). With decay ``envelopes``
    (num_slopes, T) the model is directional and its EDC loss is the
    directional one, from sample ``mixing`` on, ``max_len`` long, against
    the batch's common-slope amplitudes; there is no EDR loss then, and
    ``use_matmul_irfft`` runs its irfft as ``ops/mxu_fft.irfft_matmul``.

    ``shard`` (``parallel/collectives.Shard``): the model is evaluated on this
    rank's bins or receivers and gathered whole (for receivers, the batch's
    model inputs are this rank's and its targets the whole batch's), every
    loss is taken on the whole, and the terms of parameters alone (the
    sub-FDN terms; the regularizer under a bin shard) carry their gradient
    on the shard's first rank only.
    """
    h = model(batch) if shard is None else shard.response(model, batch)
    if band_resp is not None:
        h = h * band_resp
    if envelopes is not None:
        losses = {"edc_loss": cfg.edc_loss_weight * directional_edc_loss_from_sh(
            h, model.analysis_matrix, batch["target_common_slope_amps"], envelopes, mixing,
            max_len, mask, use_matmul_irfft=use_matmul_irfft)}
    elif "target_edc_db" in batch:
        losses = _omni_losses(cfg, batch, h, mixing, max_len, edr_win, edr_hop, mask,
                              erb_filters, freq_weights)
    else:  # a single-position batch: the raw target spectrum
        target = batch["target_rir_response"]
        losses = {
            "edr_loss": cfg.edr_loss_weight * edr_loss(
                target, h, edr_win, edr_hop, reduced_pole_radius=cfg.reduced_pole_radius,
                erb_filters=erb_filters, frequency_weights=freq_weights),
            "edc_loss": cfg.edc_loss_weight * edc_loss(target, h, mixing, max_len, mask),
        }
    if reg_len is not None:
        head = model.output_filter_params(batch)
        if shard is not None and shard.of == "receivers":
            head = {k: shard.whole(v, 0) for k, v in head.items()}
        reg = reg_loss(head["biquad_num"], head["biquad_den"], reg_len)
        losses["reg_loss"] = reg if shard is None or shard.of == "receivers" else \
            shard.replicated(reg)
    if cfg.use_colorless_loss:
        h_out, _ = model.sub_fdn_output(sub_fdn_bins(model, batch["z_values"]),
                                        sub_inverse)  # (F, G)
        spectral_fn = amse_loss if cfg.use_asym_spectral_loss else mse_loss
        spectral = 0.0
        for k in range(model.num_groups):
            spectral = spectral + cfg.spectral_loss_weight * spectral_fn(
                h_out[..., k], torch.ones_like(h_out[..., k].real)
            )
        ortho = model.feedback_loop.orthogonal_blocks()
        sparsity = cfg.sparsity_loss_weight * sparsity_loss(ortho[-1])
        if shard is not None:
            spectral, sparsity = shard.replicated(spectral), shard.replicated(sparsity)
        losses["spectral_loss"] = spectral
        losses["sparsity_loss"] = sparsity
    return losses


def sub_fdn_bins(model: torch.nn.Module, z: torch.Tensor) -> torch.Tensor:
    """The z at which the trainer evaluates the lossless sub-FDNs: all bins,
    or all but the DC bin z[0] when the groups have an odd number of lines
    (their loops are singular there, ROADMAP C10)."""
    return z[1:] if model.num_delay_lines_per_group % 2 else z


def _omni_losses(cfg: TrainerConfig, batch: Batch, h: torch.Tensor, mixing: int, max_len: int,
                 edr_win: int, edr_hop: int, mask: Optional[torch.Tensor],
                 erb_filters: Optional[torch.Tensor], freq_weights: Optional[torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """EDC and EDR of the responses h (B, F) against the batch's target features."""
    n = 2 * (h.shape[-1] - 1)
    rir = torch.fft.irfft(h, n, dim=-1)
    end = min(max_len, n)
    losses = {
        "edc_loss": cfg.edc_loss_weight
        * edc_loss_from_rir(batch["target_edc_db"], rir[..., mixing:end], mask)
    }
    rir_env = rir
    if cfg.reduced_pole_radius != 1.0:
        rir_env = rir * torch.pow(
            1.0 / cfg.reduced_pole_radius,
            torch.arange(n, dtype=torch.float32, device=rir.device),
        )
    losses["edr_loss"] = cfg.edr_loss_weight * edr_loss_from_rir(
        batch["target_edr_db"], batch["target_edr_abs_sum"], rir_env,
        win_size=edr_win, hop_size=edr_hop, erb_filters=erb_filters,
        frequency_weights=freq_weights,
    )
    return losses


ERB_BANDS = 2 ** 6


def edr_options(cfg: TrainerConfig, sample_rate: float, edr_win: int, device: torch.device
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(ERB filters (64, edr_win / 2 + 1), frequency weights) of the EDR loss
    on ``device``, each None when the config leaves it off. With ERB grouping
    the weights are taken at the ERB band centres (the EDR's frequency axis
    is then the bands), else at the STFT's bins."""
    erb, centres = None, None
    if cfg.use_erb_edr_loss:
        fb, centres = erb_filterbank(sample_rate, edr_win, ERB_BANDS)
        erb = torch.as_tensor(fb, dtype=torch.float32, device=device)
    weights = None
    if cfg.use_frequency_weighting:
        freqs = centres if centres is not None else np.fft.rfftfreq(edr_win, d=1.0 / sample_rate)
        weights = frequency_weighting(freqs).to(device)
    return erb, weights


def reg_length(cfg: TrainerConfig, model: torch.nn.Module, sample_rate: float) -> Optional[int]:
    """Samples of the aliasing regularizer's impulse responses
    (``output_filt_ir_len_ms``) when ``use_reg_loss`` is on and the model has
    SVF output heads, else None (the regularizer is off). A
    :class:`DiffGFDNVarSourceReceiverPos` with it raises ``ValueError``: the
    JAX trainer fails there (the model has no ``output_filter_params``,
    ROADMAP C19)."""
    if not (cfg.use_reg_loss and getattr(model, "use_svf_in_output", False)):
        return None
    if not hasattr(model, "output_filter_params"):
        raise ValueError(
            f"use_reg_loss with {type(model).__name__}: the JAX trainer has no output-filter "
            "parameters to regularize for this model and fails there (ROADMAP C19)")
    return ms_to_samps(cfg.output_filt_ir_len_ms, sample_rate)


@torch.no_grad()
def upload_model_inputs(arrays, device: torch.device) -> Batch:
    """The model's inputs for every receiver on the device, from one upload:
    z, the source and listener positions, the early spectra (rfft of the
    early segments there) and, when the dataset has one, the floor-plan mesh
    that meshgrid heads read."""
    nfft = 2 * (arrays.z_values.shape[0] - 1)
    early = torch.as_tensor(arrays.target_early_time, dtype=torch.float32, device=device)
    data = {
        "z_values": torch.as_tensor(arrays.z_values, device=device),
        "source_position": torch.as_tensor(arrays.source_position, device=device),
        "listener_position": torch.as_tensor(arrays.listener_position, device=device),
        "norm_listener_position": torch.as_tensor(arrays.norm_listener_position, device=device),
        "target_early_response": torch.fft.rfft(early, n=nfft, dim=-1),
    }
    if arrays.mesh_2d is not None:  # the meshgrid heads' floor plan
        data["mesh_2d"] = torch.as_tensor(arrays.mesh_2d, dtype=torch.float32, device=device)
    return data


# batch entries every receiver shares: gathered whole, never indexed
SHARED_KEYS = ("z_values", "mesh_2d")


@torch.no_grad()
def target_features(rirs: torch.Tensor, mixing: int, max_len: int, edr_win: int,
                    edr_hop: int, erb_filters: Optional[torch.Tensor] = None) -> Batch:
    """Target EDC (dB) from sample ``mixing`` to ``max_len``, target EDR (dB)
    (grouped by ``erb_filters`` when given) and its |.| sum of a chunk of
    RIRs (..., nfft)."""
    edc = db(schroeder_backward_int(rirs[..., mixing:min(max_len, rirs.shape[-1])]),
             is_squared=True)
    s = stft(rirs, edr_win, edr_hop)
    if erb_filters is not None:
        s = torch.matmul(erb_filters, torch.abs(s))
    edr = edr_from_stft(s)
    return {"target_edc_db": edc, "target_edr_db": edr,
            "target_edr_abs_sum": torch.sum(torch.abs(edr), dim=(-2, -1))}


def target_rirs(arrays, nfft: int, device: torch.device) -> torch.Tensor:
    """The dataset's target RIRs (R, nfft) on the device, zero padded or cut.

    The one upload site of the targets: from 64 MiB of float32 they travel
    as int8 blocks and are dequantized on the device, as the JAX package's
    ``device_target_rir_time`` does (``utils/cio.py``)."""
    rirs = upload_target_rirs(arrays.target_rir_time, device)
    return torch.nn.functional.pad(rirs[:, :nfft], (0, max(0, nfft - rirs.shape[1])))


class GFDNTrainer(GraphedSteps):
    """Trainer for position-conditioned (grid) GFDNs.

    ``device`` defaults to CUDA and raises without a card unless the caller
    passes ``device="cpu"``; the model is moved there.
    """

    patience: int = 5
    early_stop_tol: float = 1e-3
    # (num_slopes, T) decay envelopes of a directional trainer's EDC loss
    directional_envelopes: Optional[torch.Tensor] = None
    # the directional loss's irfft as the four-step matmul transform
    # (ops/mxu_fft.py); off by default, as in the JAX trainer
    use_mxu_fft: bool = False

    def __init__(
        self,
        model: torch.nn.Module,
        trainer_config: TrainerConfig,
        steps_per_epoch: int,
        common_decay_times: Optional[np.ndarray] = None,
        subband_filter_resp: Optional[np.ndarray] = None,
        sample_rate: Optional[float] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        cfg = trainer_config
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.sample_rate = sample_rate or model.sample_rate
        max_ir_len_ms = (
            2000.0 if common_decay_times is None else float(np.max(common_decay_times)) * 1e3
        )
        self.mixing_time_samps = ms_to_samps(20.0, self.sample_rate)
        self.max_ir_len_samps = ms_to_samps(max_ir_len_ms, self.sample_rate)
        # EDR STFT window: 4096, shrunk for short IRs so there are >= 4 frames
        time_len = cfg.num_freq_bins if cfg.num_freq_bins is not None else 2 ** 17
        self.edr_win = min(2 ** 12, 2 ** int(np.log2(max(time_len // 4, 8))))
        self.edr_hop = self.edr_win // 2
        self.erb_filters, self.freq_weights = edr_options(cfg, self.sample_rate, self.edr_win,
                                                          self.device)
        self.reg_len = reg_length(cfg, model, self.sample_rate)

        # subband training: H is multiplied by the band filter's response on
        # the training grid (F,); the targets are the dataset's own
        self.subband_filter_resp = (
            None if subband_filter_resp is None
            else torch.as_tensor(np.asarray(subband_filter_resp, np.complex64), device=self.device)
        )

        self.train_loss: List[float] = []
        self.valid_loss: List[float] = []
        self.individual_train_loss: List[Dict[str, float]] = []
        self.individual_valid_loss: List[Dict[str, float]] = []
        self._early_stop = 0
        self.features: Optional[Batch] = None
        self.data: Optional[Batch] = None
        # steps and full validation batches through captured graphs; False
        # runs the same step closures eagerly (step-level introspection)
        self.init_graphs(self.device)
        self.scheduler = None
        self.mask_generator = torch.Generator(device=self.device).manual_seed(0)

    # ----------------------------- loss assembly -----------------------------

    def edc_mask_length(self, num_bins: int) -> int:
        """Samples of the EDC window (and of its time mask) at ``num_bins`` bins."""
        return min(self.max_ir_len_samps, 2 * (num_bins - 1)) - self.mixing_time_samps

    def _losses(self, batch: Batch, edc_mask_values: Optional[torch.Tensor] = None,
                sub_inverse: Optional[torch.Tensor] = None, shard=None
                ) -> Dict[str, torch.Tensor]:
        """The weighted losses of one batch, as the JAX trainer's fast path.

        ``edc_mask_values``: the EDC time mask to use when ``use_edc_mask`` is
        on; None draws one from ``mask_generator``. ``sub_inverse``: the
        sub-FDN inverse at the batch's :func:`sub_fdn_bins`, when already
        evaluated this step. ``shard``: as :func:`gfdn_losses` takes it.
        """
        mask = None
        if self.cfg.use_edc_mask:
            mask = edc_mask_values
            if mask is None:
                length = self.edc_mask_length(batch["z_values"].shape[0])
                mask = edc_mask(length, self.mask_generator, self.device)
        with self.model.feedback_loop.sharing_orthogonal_blocks():
            return gfdn_losses(
                self.model, self.cfg, batch, self.mixing_time_samps, self.max_ir_len_samps,
                self.edr_win, self.edr_hop, self.subband_filter_resp, mask,
                self.directional_envelopes, sub_inverse, self.erb_filters, self.freq_weights,
                None if self.directional_envelopes is not None else self.reg_len, shard,
                self.use_mxu_fft,
            )

    def loss_and_grads(self, batch: Batch, edc_mask_values: Optional[torch.Tensor] = None,
                       sub_inverse: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Zero the gradients, then the total loss of one batch and its
        backward: the parameters' ``.grad`` hold the step's gradients."""
        for p in self.model.parameters():
            p.grad = None
        losses = self._losses(batch, edc_mask_values, sub_inverse)
        total = sum(losses.values())
        total.backward()
        return total.detach(), {k: v.detach() for k, v in losses.items()}

    def draw_edc_mask(self) -> Optional[torch.Tensor]:
        """A step's EDC time mask from ``mask_generator`` when the config
        uses one, else None."""
        if not self.cfg.use_edc_mask:
            return None
        return edc_mask(self.edc_mask_length(self.data["z_values"].shape[0]),
                        self.mask_generator, self.device)

    def _train_step(self, idx: Optional[torch.Tensor], mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The step closure: the per-step normalization of scalar heads, then
        the loss, its backward and the optimizer step on the gathered batch."""
        sub_inverse = None
        if not self.model.use_svf_in_output:
            sub_inverse = self._normalize_params(keep_inverse=self.cfg.use_colorless_loss)
        total, aux = self.loss_and_grads(self.gather(idx), mask, sub_inverse)
        self.optimizer.step()
        return total, aux

    def _valid_step(self, idx: torch.Tensor, mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The validation closure: the total and each loss of one batch, no gradient."""
        with torch.no_grad():
            losses = self._losses(self.gather(idx), mask)
        return sum(losses.values()), losses

    def fit_step(self, idx: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step of :meth:`fit_indexed` on the receivers ``idx`` (a device
        tensor), graphed with ``scan_epochs``, then the schedule's step.
        Returns the device-resident losses (no host sync): with
        ``scan_epochs`` on the card, the graph's outputs, valid until the
        next step."""
        out = self.run_step("train", self._train_step, idx=idx, mask=self.draw_edc_mask())
        self.scheduler.step()
        return out

    def valid_step(self, idx: torch.Tensor, batch_size: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The losses of the validation batch ``idx`` (total, {name: loss});
        a full one of ``batch_size`` through the validation graph with
        ``scan_epochs`` (:meth:`run_valid`)."""
        return self.run_valid(self._valid_step, batch_size, idx=idx, mask=self.draw_edc_mask())

    # ----------------------- device-resident data path -----------------------

    @torch.no_grad()
    def precompute_target_features(self, arrays, chunk: int = 32) -> None:
        """Target EDC (dB) after truncation, target EDR (dB) and its |.| sum per
        receiver, computed once on the device from the time-domain RIRs (zero
        padded or cut to nfft) and kept there."""
        rirs = target_rirs(arrays, 2 * (arrays.z_values.shape[0] - 1), self.device)
        chunks = [
            target_features(rirs[k : k + chunk], self.mixing_time_samps, self.max_ir_len_samps,
                            self.edr_win, self.edr_hop, self.erb_filters)
            for k in range(0, rirs.shape[0], chunk)
        ]
        self.features = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        self.data = None

    @torch.no_grad()
    def upload_arrays(self, arrays) -> Batch:
        """The model inputs and loss features on the device, from one upload:
        z, positions, the early spectra (rfft of the early segments on the
        device) and the precomputed target features."""
        if self.features is None:
            self.precompute_target_features(arrays)
        self.data = {**upload_model_inputs(arrays, self.device), **self.features}
        self.graphs.clear()
        return self.data

    def gather(self, idx: torch.Tensor) -> Batch:
        """One batch gathered on the device (z and the mesh are shared by
        every receiver)."""
        return {k: v if k in SHARED_KEYS else v[idx] for k, v in self.data.items()}

    # ---------------------------- normalization ------------------------------

    def _require_sub_fdns(self) -> None:
        """Raise ``ValueError`` when the io gains would be normalized on a
        loop without per-group sub-FDNs (RANDOM coupling: one dense matrix).
        The JAX trainer fails at that point with an ``AttributeError``
        (ROADMAP C16); the port does not invent a normalization for it."""
        fl = self.model.feedback_loop
        if fl.coupling_matrix_type is CouplingMatrixType.RANDOM:
            raise ValueError(
                "the io-gain normalization needs per-group sub-FDNs, and a RANDOM feedback "
                "matrix has none: the JAX trainer cannot train this model either "
                "(ROADMAP C16)")

    def _normalize_params(self, keep_inverse: bool = False) -> Optional[torch.Tensor]:
        """Scale b and c so each sub-FDN has unit average energy: divide each
        group's io gains by E[|H_sub_g|^2]^(1/4), in place. A no-op returning
        None when the io gains are fixed (a colorless warm start), as in JAX.

        ``keep_inverse``: evaluate the sub-FDN inverse with its autograd graph
        and return it, for the step's colorless loss to reuse (the gains
        rescaled here do not enter it); else return None.
        """
        if self.model.io_gains_fixed:
            return None
        self._require_sub_fdns()
        z = sub_fdn_bins(self.model, self.data["z_values"])
        with torch.set_grad_enabled(keep_inverse):
            p = self.model.sub_fdn_inverse(z)
        with torch.no_grad():
            h_sub, _ = self.model.sub_fdn_output(z, p.detach())
            scale = torch.pow(torch.mean(torch.abs(h_sub) ** 2, dim=0), 0.25)  # (G,)
            per_line = torch.repeat_interleave(
                scale, self.model.num_delay_lines_per_group)[:, None]
            self.model.input_gains.div_(per_line)
            self.model.output_gains.div_(per_line)
        return p if keep_inverse else None

    # ------------------------------- training --------------------------------

    def fit_indexed(
        self,
        arrays,
        train_idx: np.ndarray,
        valid_idx: np.ndarray,
        seed: int = 0,
        resume: bool = False,
    ) -> torch.nn.Module:
        """Epoch loop over device-resident data; returns the trained model.

        Batch order and splits come from ``np.random.RandomState(seed)`` as in
        the JAX trainer. ``resume=True`` restarts from the newest checkpoint
        in ``train_dir`` and its optimizer-state sidecar.
        """
        cfg = self.cfg
        if not self.model.io_gains_fixed:
            self._require_sub_fdns()
        start_epoch, resumed = 0, None
        if resume:
            found = load_latest_checkpoint_with_epoch(cfg.train_dir, cfg.max_epochs - 1)
            if found is not None:
                tree, last_epoch = found
                load_jax_params(self.model, tree)
                start_epoch = last_epoch + 1
                resumed = load_opt_state(cfg.train_dir, last_epoch, self.device)
                logger.info("resuming from epoch %d (%s optimizer state)", start_epoch,
                            "with" if resumed is not None else "without")
        # no sidecar: Adam restarts, but the step decay resumes at its position
        count_offset = start_epoch * self.steps_per_epoch if resume and resumed is None else 0
        self.optimizer, self.scheduler = make_optimizer(
            cfg, self.model, self.steps_per_epoch, count_offset=count_offset
        )
        if resumed is not None:
            load_optimizer_state(self.optimizer, self.scheduler, resumed)
        if len(train_idx) == 0:
            raise ValueError("no training items: train_idx is empty (check "
                             "train_valid_split / dataset size)")
        if self.data is None:
            self.upload_arrays(arrays)
        self.mask_generator.manual_seed(seed)
        bs = min(cfg.batch_size, max(1, len(train_idx)))
        vbs = min(cfg.batch_size, max(1, len(valid_idx)))
        vfull, vrem = exact_valid_batches(valid_idx, vbs)
        valid_batches = [
            torch.as_tensor(np.asarray(b), dtype=torch.long, device=self.device)
            for b in vfull + ([vrem] if len(vrem) else [])
        ]
        if start_epoch == 0:
            save_checkpoint(cfg.train_dir, -1, jax_params_from_torch(self.model))

        rng = np.random.RandomState(seed)
        for _ in range(start_epoch):  # replay: a resumed run sees the same batch order
            rng.permutation(len(train_idx))
        start = time.time()
        for epoch in range(start_epoch, cfg.max_epochs):
            ep_start = time.time()
            perm = train_idx[rng.permutation(len(train_idx))]
            idx_mat = torch.as_tensor(
                np.stack(list(padded_batches(perm, bs))), dtype=torch.long, device=self.device
            )
            if self.model.use_svf_in_output:
                self._normalize_params()
            ep_total, ep_aux = 0.0, {}
            for idx in idx_mat:
                total, aux = self.fit_step(idx)
                ep_total = ep_total + total
                ep_aux = {k: ep_aux.get(k, 0.0) + v for k, v in aux.items()}
            v_total, v_aux, v_weight = 0.0, {}, 0
            for vidx in valid_batches:
                total, losses = self.valid_step(vidx, vbs)
                w = len(vidx)
                v_total = v_total + total * w
                v_aux = {k: v_aux.get(k, 0.0) + v * w for k, v in losses.items()}
                v_weight += w
            # the epoch's one read of device values
            keys = list(ep_aux)
            vkeys = list(v_aux)
            row = [ep_total] + [ep_aux[k] for k in keys]
            if v_weight:
                row += [v_total] + [v_aux[k] for k in vkeys]
            host = torch.stack([torch.as_tensor(x, device=self.device) for x in row]).tolist()
            n_steps = idx_mat.shape[0]
            self.train_loss.append(host[0] / n_steps)
            self.individual_train_loss.append(
                {k: host[1 + i] / n_steps for i, k in enumerate(keys)}
            )
            if v_weight:
                base = 1 + len(keys)
                self.valid_loss.append(host[base] / v_weight)
                self.individual_valid_loss.append(
                    {k: host[base + 1 + i] / v_weight for i, k in enumerate(vkeys)}
                )
            else:
                self.valid_loss.append(0.0)
                self.individual_valid_loss.append({})
            save_checkpoint(cfg.train_dir, epoch, jax_params_from_torch(self.model))
            save_opt_state(cfg.train_dir, epoch, {"optimizer": self.optimizer.state_dict(),
                                                  "scheduler": self.scheduler.state_dict()})
            logger.info("epoch %d train %.4f valid %.4f (%.2fs)", epoch, self.train_loss[-1],
                        self.valid_loss[-1], time.time() - ep_start)
            # an empty validation split pins valid_loss at 0.0, which must not
            # trip early stopping
            if len(valid_idx) > 0 and len(self.valid_loss) >= 2:
                if abs(self.valid_loss[-2] - self.valid_loss[-1]) <= self.early_stop_tol:
                    self._early_stop += 1
                else:
                    self._early_stop = 0
            if self._early_stop == self.patience:
                logger.info("early stopping at epoch %d", epoch)
                break
        logger.info("training time: %.3fs", time.time() - start)
        return self.model

    # ------------------------------ IR export --------------------------------

    def save_irs(
        self,
        batches: Iterable[np.ndarray],
        directory,
        filename_prefix: str = "ir",
        norm: bool = True,
    ) -> None:
        """Write the model's RIRs for batches of receiver indices as wav
        files named by the receivers' positions."""
        from ..inference.gfdn_inference import make_rir_synthesis_fn

        synth = make_rir_synthesis_fn(self.model, self.cfg.reduced_pole_radius)
        os.makedirs(directory, exist_ok=True)
        for idx in batches:
            batch = self.gather(torch.as_tensor(idx, device=self.device))
            rirs = synth(batch).cpu().numpy()
            if norm:
                rirs = rirs / (np.max(np.abs(rirs)) + 1e-12)
            for rir, pos in zip(rirs, batch["listener_position"].cpu().numpy()):
                name = f"{filename_prefix}_({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}).wav"
                write_wav(os.path.join(directory, name), rir, self.sample_rate)


class DirectionalGFDNTrainer(GFDNTrainer):
    """Trainer of a directional FDN: SH responses -> the directional EDC loss.

    Construct with ``directional_envelopes`` (num_slopes, T) from
    :func:`diffgfdn_torch.losses.make_decay_envelopes`. Its targets are the
    receivers' common-slope amplitudes: it uploads those and the positions,
    and has no target feature to precompute.
    """

    def __init__(self, *args, directional_envelopes: Union[np.ndarray, torch.Tensor], **kwargs):
        super().__init__(*args, **kwargs)
        self.directional_envelopes = torch.as_tensor(
            directional_envelopes, dtype=torch.float32, device=self.device)

    def edc_mask_length(self, num_bins: int) -> int:
        """Samples of the directional EDC window (``max_ir_len_samps`` from
        the mixing time) at ``num_bins`` bins."""
        n = 2 * (num_bins - 1)
        return min(self.max_ir_len_samps + self.mixing_time_samps, n) - self.mixing_time_samps

    def precompute_target_features(self, arrays, chunk: int = 32) -> None:
        """No target feature: the targets are the common-slope amplitudes."""
        self.features, self.data = {}, None

    @torch.no_grad()
    def upload_arrays(self, arrays) -> Batch:
        """z, the positions and the common-slope amplitudes on the device."""
        self.data = {
            "z_values": torch.as_tensor(arrays.z_values, device=self.device),
            "listener_position": torch.as_tensor(arrays.listener_position, device=self.device),
            "norm_listener_position": torch.as_tensor(arrays.norm_listener_position,
                                                      device=self.device),
            "target_common_slope_amps": torch.as_tensor(
                arrays.target_common_slope_amps, dtype=torch.float32, device=self.device),
        }
        self.graphs.clear()
        return self.data


class SinglePosGFDNTrainer(GFDNTrainer):
    """Single-RIR fit: one full-spectrum batch, on the card once, one
    optimizer step an epoch, early stopping on the train loss (tolerance
    1e-4, patience 5).

    The losses compare raw spectra (:func:`gfdn_losses`' single-position
    branch). Before the first step the io gains are normalized per sub-FDN
    (unless fixed by a colorless warm start), then, when both heads are
    scalars, the io scalars are scaled so that the model's average energy
    matches the target's.

    ``freq_mesh`` (``parallel/mesh.Mesh``): the ranks to shard the rFFT bin
    axis over (the single-position batch is the whole unit circle, so
    frequency is its one axis to share out). A mesh with process groups
    trains through ``parallel/freq_parallel.make_freq_sharded_step``: each
    rank evaluates its bins, every rank takes the loss on the gathered
    spectrum, the energy match reads the gathered H, and the parameters
    start from rank 0's and stay bit-identical, so every rank stops at the
    same epoch. Only rank 0 writes checkpoints. None trains unsharded.
    """

    early_stop_tol = 1e-4

    def __init__(self, *args, freq_mesh=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.freq_mesh = freq_mesh
        self.used_freq_parallel = False
        self._fit_run = None
        self._step_mask: Optional[torch.Tensor] = None
        self._shard = None
        if freq_mesh is not None:
            self.collective_backend = freq_mesh.backend

    @property
    def sharded(self) -> bool:
        return self.freq_mesh is not None and self.freq_mesh.distributed

    @property
    def writes(self) -> bool:
        """True on the rank that writes checkpoints: rank 0 of a sharded fit."""
        return not self.sharded or self.freq_mesh.index == 0

    def _sharded_losses(self, batch: Batch, shard) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        losses = self._losses(batch, self._step_mask, shard=shard)
        return sum(losses.values()), losses

    def _make_fit_step(self):
        """The step of each epoch on the uploaded batch: frequency-sharded on a
        mesh with process groups (the JAX trainer's test is a mesh of more
        than one device; a process group of one rank still runs its
        collectives), else None (the unsharded step)."""
        if not self.sharded:
            return None
        from ..parallel.collectives import shard_of
        from ..parallel.freq_parallel import make_freq_sharded_step

        self.used_freq_parallel = True
        self._shard = shard_of(self.freq_mesh, "batch", self.data["z_values"].shape[0], "bins")
        logger.info("single-pos fit: frequency axis sharded over %d ranks", self.freq_mesh.size)
        return make_freq_sharded_step(self.model, self._sharded_losses, self.optimizer,
                                      self.freq_mesh)

    @torch.no_grad()
    def upload_batch(self, batch: Dict[str, np.ndarray]) -> Batch:
        """The full-spectrum batch (numpy) on the device, once."""
        self.data = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in batch.items()}
        self.graphs.clear()
        return self.data

    @torch.no_grad()
    def _normalize_params(self, keep_inverse: bool = False) -> Optional[torch.Tensor]:
        """The sub-FDN normalization, then the energy match of the io scalars:
        both divided by (E|H|^2 / E|target|^2)^(1/4), in place."""
        super()._normalize_params()
        model = self.model
        if model.use_svf_in_output or model.use_svf_in_input:
            return None
        h = model(self.data) if self._shard is None else self._shard.response(model, self.data)
        if self.subband_filter_resp is not None:
            h = h * self.subband_filter_resp
        energy_h = torch.mean(torch.abs(h) ** 2)
        energy_t = torch.mean(torch.abs(self.data["target_rir_response"]) ** 2)
        ratio = torch.pow(energy_h / (energy_t + 1e-12), 0.25)
        model.input_scalars.div_(ratio)
        model.output_scalars.div_(ratio)
        return None

    def _train_step(self, idx: Optional[torch.Tensor], mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The step closure: one optimizer step on the whole spectrum (the
        batch is the single position, uploaded once: ``idx`` is None), its
        bins sharded over ``freq_mesh`` when it has process groups."""
        if self._fit_run is not None:
            self._step_mask = mask
            return self._fit_run(self.data)
        total, aux = self.loss_and_grads(self.data, mask)
        self.optimizer.step()
        return total, aux

    def fit_step(self, idx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One optimizer step on the whole spectrum, graphed with
        ``scan_epochs`` (``idx`` is not used). Returns the device-resident
        losses."""
        return super().fit_step(None)

    def fit(self, batch: Dict[str, np.ndarray], seed: int = 0) -> torch.nn.Module:
        """Train on the full-spectrum ``batch`` (numpy: ``z_values``,
        ``listener_position``, ``norm_listener_position``,
        ``target_early_response``, ``target_late_response``,
        ``target_rir_response``) for up to ``max_epochs`` epochs of one step;
        returns the trained model."""
        cfg = self.cfg
        self.mask_generator.manual_seed(seed)
        self.upload_batch(batch)
        if self.sharded:
            from ..parallel.collectives import broadcast_tensors

            broadcast_tensors(self.model.parameters(), self.freq_mesh.batch_group)
        self.optimizer, self.scheduler = make_optimizer(cfg, self.model, 1)
        self._fit_run = self._make_fit_step()
        self._normalize_params()
        if self.writes:
            save_checkpoint(cfg.train_dir, -1, jax_params_from_torch(self.model))
        start = time.time()
        for epoch in range(cfg.max_epochs):
            total, aux = self.fit_step()
            keys = list(aux)
            host = torch.stack([total] + [aux[k] for k in keys]).tolist()  # one read
            self.train_loss.append(host[0])
            self.individual_train_loss.append(dict(zip(keys, host[1:])))
            if self.writes:
                save_checkpoint(cfg.train_dir, epoch, jax_params_from_torch(self.model))
            logger.info("epoch %d train %.4f", epoch, self.train_loss[-1])
            if len(self.train_loss) >= 2:
                if abs(self.train_loss[-2] - self.train_loss[-1]) <= self.early_stop_tol:
                    self._early_stop += 1
                else:
                    self._early_stop = 0
            if self._early_stop == self.patience:
                logger.info("early stopping at epoch %d", epoch)
                break
        logger.info("training time: %.3fs", time.time() - start)
        return self.model
