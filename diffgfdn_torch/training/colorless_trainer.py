"""Colorless-FDN trainer (port of ``training/colorless_trainer.py``).

|H| -> 1 on bins of the upper unit circle, with a sparsity bonus on the
feedback matrix: loss = spectral(|H|, 1) + alpha * sparsity(A); validation
adds the per-delay-line spectral term. The bins are split into train and
valid sets, and each epoch's train bins permuted, by
``np.random.RandomState(seed)`` as in the JAX trainer; the io gains are
scaled to unit average energy once before training; Adam with a step
decay of 0.1 every 10 epochs; a JAX-format checkpoint per epoch. Losses stay
on the device until the epoch's one read. With ``scan_epochs`` (the default)
each step and each validation batch runs through a step graph
(``training/scan.py``), captured once on the card and replayed; its static
input is the batch's bin indices, which the host refills from the epoch's
permutation.
"""

import logging
import time
from typing import List, Optional, Union

import numpy as np
import torch

from ..config.schema import ColorlessFDNConfig
from ..losses import amse_loss, mse_loss, sparsity_loss
from ..models.colorless import ColorlessFDN
from ..utils.device import resolve_device
from ..utils.params import jax_params_from_torch
from .checkpoints import save_checkpoint
from .optim import make_single_lr_optimizer, STEP_SIZE_EPOCHS
from .scan import GraphedSteps

logger = logging.getLogger("diffgfdn_torch")


class ColorlessFDNTrainer(GraphedSteps):
    """Adam + StepLR(10 epochs, 0.1) on a :class:`ColorlessFDN`, on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        model: ColorlessFDN,
        config: ColorlessFDNConfig,
        train_dir: str,
        use_asym_loss: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = config
        self.train_dir = train_dir
        self.spectral_fn = amse_loss if use_asym_loss else mse_loss
        self.train_loss: List[float] = []
        self.valid_loss: List[float] = []
        self.init_graphs(self.device)
        self.scheduler = None
        self.angles: Optional[torch.Tensor] = None  # the bins' angles of the fit

    def loss(self, angles: torch.Tensor, with_per_del: bool = False) -> torch.Tensor:
        """The loss at the bins exp(1j * angles); ``with_per_del`` adds the
        per-delay-line spectral term (validation)."""
        h, h_per_del = self.model(torch.exp(1j * angles))
        spectral = self.spectral_fn(h, torch.ones_like(h.real))
        if with_per_del:
            spectral = spectral + self.spectral_fn(h_per_del, torch.ones_like(h_per_del.real))
        return spectral + self.cfg.alpha * sparsity_loss(self.model.feedback_matrix())

    def _train_step(self, idx: torch.Tensor) -> torch.Tensor:
        """The step closure: loss, backward and optimizer step at the bins ``idx``."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self.angles[idx])
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _valid_step(self, idx: torch.Tensor) -> torch.Tensor:
        """The validation closure: the loss at the bins ``idx``, no gradient."""
        with torch.no_grad():
            return self.loss(self.angles[idx], with_per_del=True)

    def fit_step(self, idx: torch.Tensor) -> torch.Tensor:
        """One optimizer step at the bins ``idx`` of :attr:`angles`, graphed
        with ``scan_epochs``, then the schedule's step; returns the
        device-resident loss (on the card with ``scan_epochs``, valid until
        the next step)."""
        loss = self.run_step("train", self._train_step, idx=idx)
        self.scheduler.step()
        return loss

    @torch.no_grad()
    def normalize(self, angles: torch.Tensor) -> None:
        """Scale the io gains in place to unit average FDN energy at the bins."""
        h, _ = self.model(torch.exp(1j * angles))
        scale = torch.pow(torch.mean(torch.abs(h) ** 2), 0.25)
        self.model.input_gains.div_(scale)
        self.model.output_gains.div_(scale)

    def fit(self, num_freq_samples: int, seed: int = 0) -> ColorlessFDN:
        """Train on random batches of ``num_freq_samples`` bins of the upper
        unit circle; returns the trained model."""
        cfg = self.cfg
        angles_np = (np.arange(num_freq_samples) / num_freq_samples * np.pi).astype(np.float32)
        self.angles = torch.as_tensor(angles_np, device=self.device)
        rng = np.random.RandomState(seed)
        n_train = int(num_freq_samples * cfg.train_valid_split)
        perm = rng.permutation(num_freq_samples)
        train_idx, valid_idx = perm[:n_train], perm[n_train:]
        self.optimizer, self.scheduler = make_single_lr_optimizer(
            self.model, cfg.lr, max(1, len(train_idx) // cfg.batch_size), STEP_SIZE_EPOCHS)
        self.normalize(self.angles)
        bs = min(cfg.batch_size, len(train_idx))
        vbs = min(cfg.batch_size, max(1, len(valid_idx)))
        n_valid = max(1, len(valid_idx) // vbs) if len(valid_idx) else 0
        valid_batches = [torch.as_tensor(valid_idx[k * vbs:(k + 1) * vbs], device=self.device)
                         for k in range(n_valid)]
        start = time.time()
        for epoch in range(cfg.max_epochs):
            ep = torch.as_tensor(rng.permutation(train_idx), device=self.device)
            n_steps = len(ep) // bs
            total = torch.zeros((), device=self.device)
            for k in range(n_steps):
                total = total + self.fit_step(ep[k * bs:(k + 1) * bs])
            vtotal = torch.zeros((), device=self.device)
            for vidx in valid_batches:
                vtotal = vtotal + self.run_step("valid", self._valid_step, idx=vidx)
            t, v = torch.stack([total, vtotal]).tolist()  # the epoch's one read
            self.train_loss.append(t / max(n_steps, 1))
            self.valid_loss.append(v / max(n_valid, 1))
            save_checkpoint(self.train_dir, epoch, jax_params_from_torch(self.model))
            logger.info("colorless epoch %d train %.4f valid %.4f", epoch, self.train_loss[-1],
                        self.valid_loss[-1])
        logger.info("colorless training time: %.3fs", time.time() - start)
        return self.model
