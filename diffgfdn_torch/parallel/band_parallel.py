"""Band-parallel subband training on one card (port of ``parallel/band_parallel.py``).

The JAX package trains the octave-band GFDNs of one architecture in one XLA
program over a (band, batch) device mesh. On one card there is no mesh: the
bands of a group run as one step, their parameters and buffers stacked on a
leading band axis, the band loss mapped over that axis by
``torch.func.vmap``. The kernels' autograd functions fold the band axis
into their system axis (``kernels/linalg.py``, ``kernels/sos.py``), so each
kernel of the path launches once per step for all bands of the group.

As in the JAX trainer:

* the loss of a band is the sequential trainer's (``training/trainer.py``
  :func:`gfdn_losses`) on H times the band's filter response, against target
  features computed once per dataset from the targets times that response;
* the per-band losses are summed before ``backward()``: the bands'
  parameters are disjoint and Adam is elementwise, so each band gets
  exactly its own gradient and update;
* a per-band validation pass each epoch, and per-band early stopping: a
  stopped band's update is masked to zero while its Adam state advances;
* one train / valid split and batch order per group;
* with ``scan_epochs`` (the default) each step and each validation batch
  runs through a step graph (``training/scan.py``), captured once on the
  card and replayed; its static inputs are the batch's indices, the EDC
  mask and the keep vector of stopped bands, which every step applies
  (``torch.where`` with every band active leaves the parameters as the
  optimizer left them, bit for bit).

Unlike the JAX trainer, which builds one model from the group's first
config, every band keeps its own config's model: its delay lines and
absorption cascades are stacked as buffers beside its parameters, so each
band trains on the delays that its checkpoint is served with.

The ERB-grouped EDR, frequency weighting and the aliasing regularizer of SVF
output heads are the sequential trainer's (:func:`edr_options`,
:func:`reg_length`): one filterbank and one set of weights for all bands of
the group, the target features grouped alike.
"""

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config.schema import TrainerConfig
from ..losses import edc_mask
from ..ops.basic import ms_to_samps
from ..training.optim import make_optimizer
from ..training.scan import GraphedSteps
from ..training.trainer import (
    edr_options,
    gfdn_losses,
    padded_batches,
    reg_length,
    SHARED_KEYS,
    target_features,
    target_rirs,
    upload_model_inputs,
)
from ..utils.device import resolve_device

logger = logging.getLogger("diffgfdn_torch")

Batch = Dict[str, torch.Tensor]


class _BandLoss(nn.Module):
    """The loss of one band as a module, for ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module, cfg: TrainerConfig, mixing: int, max_len: int,
                 edr_win: int, edr_hop: int, erb_filters: Optional[torch.Tensor],
                 freq_weights: Optional[torch.Tensor], reg_len: Optional[int]):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.windows = (mixing, max_len, edr_win, edr_hop)
        self.options = dict(erb_filters=erb_filters, freq_weights=freq_weights, reg_len=reg_len)

    def forward(self, batch: Batch, feats: Batch, band_resp: torch.Tensor,
                mask: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        with self.model.feedback_loop.sharing_orthogonal_blocks():
            return gfdn_losses(self.model, self.cfg, {**batch, **feats}, *self.windows,
                               band_resp, mask, **self.options)


def _stack(models: Sequence[nn.Module], named: Callable, device: torch.device
           ) -> Dict[str, torch.Tensor]:
    tensors = [dict(named(m)) for m in models]
    shapes = [{k: tuple(v.shape) for k, v in t.items()} for t in tensors]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError("band models of one group must share one architecture")
    return {k: torch.stack([t[k].detach().to(device) for t in tensors]) for k in tensors[0]}


class BandParallelTrainer(GraphedSteps):
    """Trains the GFDNs of one architecture group, one per band, as one step.

    ``models``: one model per band (its own config's delays, absorption and
    seeded parameters); ``band_responses`` (bands, F) complex: each band's
    filter response on the training grid. ``device`` defaults to CUDA and
    raises without a card unless the caller passes ``device="cpu"``.
    """

    patience: int = 5
    early_stop_tol: float = 1e-3

    def __init__(
        self,
        models: Sequence[nn.Module],
        cfg: TrainerConfig,
        band_responses: np.ndarray,
        steps_per_epoch: int,
        max_ir_len_ms: float = 2000.0,
        device: Union[str, torch.device] = "cuda",
    ):
        if len(models) != len(band_responses):
            raise ValueError(f"{len(models)} models for {len(band_responses)} band responses")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_bands = len(models)
        self.params = {
            k: nn.Parameter(v)
            for k, v in _stack(models, nn.Module.named_parameters, self.device).items()
        }
        self.buffers = _stack(models, nn.Module.named_buffers, self.device)
        self.model = models[0].to(self.device)
        self.band_responses = torch.as_tensor(
            np.asarray(band_responses, np.complex64), device=self.device
        )
        self.steps_per_epoch = max(1, steps_per_epoch)
        sample_rate = self.model.sample_rate
        time_len = cfg.num_freq_bins if cfg.num_freq_bins is not None else 2 ** 17
        self.edr_win = min(2 ** 12, 2 ** int(np.log2(max(time_len // 4, 8))))
        self.edr_hop = self.edr_win // 2
        self.mixing_time_samps = ms_to_samps(20.0, sample_rate)
        self.max_ir_len_samps = ms_to_samps(max_ir_len_ms, sample_rate)
        self.erb_filters, self.freq_weights = edr_options(cfg, sample_rate, self.edr_win,
                                                          self.device)
        self._loss = _BandLoss(self.model, cfg, self.mixing_time_samps, self.max_ir_len_samps,
                               self.edr_win, self.edr_hop, self.erb_filters, self.freq_weights,
                               reg_length(cfg, self.model, sample_rate))
        self._band_losses = torch.func.vmap(self._one_band, in_dims=(0, 0, 0, 0, None, None))
        self.init_graphs(self.device)
        self.optimizer, self.scheduler = make_optimizer(cfg, self, self.steps_per_epoch)
        self._stopped = {(False,) * self.num_bands: torch.zeros(
            self.num_bands, dtype=torch.bool, device=self.device)}
        self.mask_generator = torch.Generator(device=self.device).manual_seed(0)
        self.band_feats: Optional[Batch] = None
        self.data: Optional[Batch] = None
        self.train_loss: List[np.ndarray] = []
        self.valid_loss: List[np.ndarray] = []

    def named_parameters(self):
        """The band-stacked parameters under the single model's names (the
        optimizer labels its groups by them)."""
        return iter(self.params.items())

    @torch.no_grad()
    def load_band_params(self, state: Dict[str, torch.Tensor]) -> None:
        """Overwrite the band-stacked parameters from a port-named state (as
        ``utils/params.torch_state_from_jax`` gives it for a band-stacked tree)."""
        if set(state) != set(self.params):
            raise ValueError(f"band state keys {sorted(state)} != {sorted(self.params)}")
        for k, p in self.params.items():
            p.copy_(state[k])

    # ------------------------------ the step ---------------------------------

    def _one_band(self, params, buffers, band_resp, feats, batch, mask):
        state = {f"model.{k}": v for k, v in {**params, **buffers}.items()}
        return torch.func.functional_call(self._loss, state, (batch, feats, band_resp, mask))

    def losses(self, idx: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Each band's weighted losses on the receivers ``idx``: {name: (bands,)}."""
        return self._band_losses(self.params, self.buffers, self.band_responses,
                                 self.gather_feats(idx), self.gather(idx), mask)

    def _edc_mask(self) -> Optional[torch.Tensor]:
        if not self.cfg.use_edc_mask:
            return None
        n = 2 * (self.data["z_values"].shape[0] - 1)
        length = min(self.max_ir_len_samps, n) - self.mixing_time_samps
        return edc_mask(length, self.mask_generator, self.device)

    def loss_and_grads(self, idx: torch.Tensor, mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Zero the gradients, then each band's total loss (bands,) and the
        backward of their sum: ``.grad`` of each stacked parameter holds every
        band's own gradient."""
        for p in self.params.values():
            p.grad = None
        losses = self.losses(idx, mask)
        totals = sum(losses.values())
        totals.sum().backward()
        return totals.detach(), {k: v.detach() for k, v in losses.items()}

    def _train_step(self, idx: torch.Tensor, mask: Optional[torch.Tensor], keep: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The step closure: every band's loss, backward and optimizer step,
        then the bands where ``keep`` (bands,) is True put back as they were."""
        totals, aux = self.loss_and_grads(idx, mask)
        before = {k: p.detach().clone() for k, p in self.params.items()}
        self.optimizer.step()
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(torch.where(keep.view(-1, *([1] * (p.dim() - 1))), before[k], p))
        return totals, aux

    def _valid_step(self, idx: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The validation closure: each band's total loss (bands,), no gradient."""
        with torch.no_grad():
            return sum(self.losses(idx, mask).values())

    def stopped_bands(self, active: Optional[np.ndarray]) -> torch.Tensor:
        """(bands,) bool on the device, True where ``active`` is 0 (None: every
        band active). Each pattern is copied to the device once and kept, so
        that the steps of a run copy nothing from the host."""
        stopped = ((False,) * self.num_bands if active is None
                   else tuple(bool(a == 0) for a in np.asarray(active)))
        if stopped not in self._stopped:
            self._stopped[stopped] = torch.tensor(stopped, device=self.device)
        return self._stopped[stopped]

    def step(self, idx: torch.Tensor, active: Optional[np.ndarray] = None,
             mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One optimizer step of every band on the receivers ``idx`` (a device
        tensor), graphed with ``scan_epochs``. ``active`` (bands,) 0/1: a band
        at 0 keeps its parameters exactly, while its Adam moments advance as
        the JAX trainer's do. ``mask``: the EDC time mask (None draws one
        when the config uses it). Returns the device-resident per-band losses
        (no host sync; with ``scan_epochs`` on the card, valid until the next
        step)."""
        if mask is None:
            mask = self._edc_mask()
        out = self.run_step("train", self._train_step, idx=idx, mask=mask,
                            keep=self.stopped_bands(active))
        self.scheduler.step()
        return out

    # ----------------------- device-resident data path -----------------------

    @torch.no_grad()
    def precompute_band_target_features(self, arrays, chunk: int = 16) -> None:
        """Each band's target EDC / EDR features, computed once on the device
        from the targets times the band's response, kept with a leading band
        axis (bands, R, ...)."""
        nfft = 2 * (arrays.z_values.shape[0] - 1)
        rirs = target_rirs(arrays, nfft, self.device)
        bands = []
        for resp in self.band_responses:
            chunks = []
            for k in range(0, rirs.shape[0], chunk):
                spec = torch.fft.rfft(rirs[k : k + chunk], n=nfft, dim=-1) * resp
                chunks.append(target_features(torch.fft.irfft(spec, nfft, dim=-1),
                                              self.mixing_time_samps, self.max_ir_len_samps,
                                              self.edr_win, self.edr_hop, self.erb_filters))
            bands.append({k: torch.cat([c[k] for c in chunks]) for k in chunks[0]})
        self.band_feats = {k: torch.stack([b[k] for b in bands]) for k in bands[0]}

    def upload_arrays(self, arrays) -> Batch:
        """The model inputs of every receiver on the device (one upload) and,
        once, the bands' target features."""
        if self.band_feats is None:
            self.precompute_band_target_features(arrays)
        self.data = upload_model_inputs(arrays, self.device)
        return self.data

    def gather(self, idx: torch.Tensor) -> Batch:
        """One batch of model inputs, gathered on the device (z and the mesh
        are shared)."""
        return {k: v if k in SHARED_KEYS else v[idx] for k, v in self.data.items()}

    def gather_feats(self, idx: torch.Tensor) -> Batch:
        """The batch's target features of every band, (bands, B, ...)."""
        return {k: v[:, idx] for k, v in self.band_feats.items()}

    # ------------------------------- training --------------------------------

    def fit_indexed(
        self,
        arrays,
        train_idx: np.ndarray,
        valid_idx: Optional[np.ndarray] = None,
        max_epochs: Optional[int] = None,
        seed: int = 0,
        on_epoch: Optional[Callable] = None,
    ) -> np.ndarray:
        """Epoch loop over device-resident data; returns the per-band train
        losses (epochs, bands).

        Batch order comes from ``np.random.RandomState(seed)`` as in the JAX
        trainer. With ``valid_idx``, a per-band validation pass runs each
        epoch and each band stops on its own (|delta valid| <= tol for
        ``patience`` epochs); stopped bands freeze while the rest train.
        ``on_epoch(epoch, trainer, train_losses, valid_losses, trained)`` runs
        after each epoch; ``trained[b] == 1`` when band b trained in it. The
        host reads the device once per epoch.
        """
        if len(train_idx) == 0:
            raise ValueError("no training items: train_idx is empty")
        if self.data is None:
            self.upload_arrays(arrays)
        self.mask_generator.manual_seed(seed)
        bs = min(self.cfg.batch_size, max(1, len(train_idx)))
        valid_batches = []
        if valid_idx is not None and len(valid_idx):
            vbs = min(self.cfg.batch_size, len(valid_idx))
            valid_batches = [torch.as_tensor(b, dtype=torch.long, device=self.device)
                             for b in padded_batches(np.asarray(valid_idx), vbs)]
        rng = np.random.RandomState(seed)
        max_epochs = max_epochs or self.cfg.max_epochs
        active = np.ones(self.num_bands, np.float32)
        streak = np.zeros(self.num_bands, np.int64)
        self.train_loss, self.valid_loss = [], []
        for epoch in range(max_epochs):
            trained = active.copy()
            perm = train_idx[rng.permutation(len(train_idx))]
            idx_mat = torch.as_tensor(np.stack(list(padded_batches(perm, bs))),
                                      dtype=torch.long, device=self.device)
            ep_total = 0.0
            for idx in idx_mat:
                total, _ = self.step(idx, active)
                ep_total = ep_total + total
            row = [ep_total / idx_mat.shape[0]]
            if valid_batches:
                v_total = 0.0
                for vidx in valid_batches:
                    v_total = v_total + self.run_step("valid", self._valid_step, idx=vidx,
                                                      mask=self._edc_mask())
                row.append(v_total / len(valid_batches))
            host = torch.stack(row).cpu().numpy()  # the epoch's one read of device values
            self.train_loss.append(host[0])
            v_epoch = host[1] if valid_batches else None
            if v_epoch is not None:
                self.valid_loss.append(v_epoch)
                if len(self.valid_loss) >= 2:
                    delta = np.abs(self.valid_loss[-2] - self.valid_loss[-1])
                    streak = np.where(delta <= self.early_stop_tol, streak + 1, 0)
                    active = np.where(streak >= self.patience, 0.0, active).astype(np.float32)
            logger.info("epoch %d train %s valid %s active %s", epoch, host[0], v_epoch, active)
            if on_epoch is not None:
                on_epoch(epoch, self, host[0], v_epoch, trained)
            if valid_batches and not active.any():
                break
        return np.stack(self.train_loss)
