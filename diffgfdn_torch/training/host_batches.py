"""Batches made on the host, on the device (the upload of ``GFDNTrainer.fit``
and ``BandParallelTrainer.step`` / ``fit``).

The JAX package's host-batch entry points encode each batch and send it
with its step. Here :class:`HostBatches` sends a batch up so:

* the entries every receiver shares (:data:`SHARED_KEYS`: z, the floor-plan
  mesh, the SH directions) go up once and stay while the caller passes the
  same array;
* of the other entries only those that the step reads go up, through pinned
  staging memory, by asynchronous copies on the current stream; before the
  host overwrites a staging buffer it waits for the copies that last read
  from it, so the host gathers the next batch while the card runs a step;
* an entry that is already a tensor (loss features that a trainer computed
  on the device and ``gather_batch`` gathered there) stays where it lies;
* on the CPU the arrays are wrapped as tensors, no copy.
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# batch entries every receiver shares: sent up once, never indexed
SHARED_KEYS = ("z_values", "mesh_2d", "sph_directions")
# the grid models' inputs (the source position is read by source heads)
MODEL_KEYS = ("source_position", "listener_position", "norm_listener_position",
              "target_early_response")
# the precomputed target features of the grid losses
FEATURE_KEYS = ("target_edc_db", "target_edr_db", "target_edr_abs_sum")


def loss_keys(batch: Dict) -> Tuple[str, ...]:
    """The target entries the grid losses read from ``batch``: its precomputed
    features when it carries them, else its raw target spectrum (as the JAX
    trainer's two branches)."""
    return FEATURE_KEYS if "target_edc_db" in batch else ("target_rir_response",)


def grid_keys(batch: Dict) -> Tuple[str, ...]:
    """The entries of a grid batch that a training step reads: the model
    inputs it has and the losses' targets."""
    return tuple(k for k in MODEL_KEYS if k in batch) + loss_keys(batch)


class HostBatches:
    """Sends host batches to ``device``; ``bytes`` is what the last batch
    copied up (shared entries sent before it not counted)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bytes = 0
        self._shared: Dict[str, Tuple[object, torch.Tensor]] = {}
        self._staging: Dict[tuple, torch.Tensor] = {}
        self._copied: Optional["torch.cuda.Event"] = None

    def shared(self, key: str, value) -> torch.Tensor:
        """The device copy of the shared entry ``key``, sent up when the
        caller passes another array than last time."""
        held = self._shared.get(key)
        if held is None or held[0] is not value:
            held = self._shared[key] = (value, torch.as_tensor(np.asarray(value),
                                                               device=self.device))
        return held[1]

    def __call__(self, batch: Dict, keys: Iterable[str]) -> Dict[str, torch.Tensor]:
        """The shared entries of ``batch`` and its entries ``keys`` on the
        device; the copies are queued on the current stream."""
        out = {k: self.shared(k, v) for k, v in batch.items() if k in SHARED_KEYS}
        if self._copied is not None:
            self._copied.synchronize()  # the staging buffers are free again
        self.bytes = 0
        for k in keys:
            out[k] = self._entry(k, batch[k])
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return out

    def _entry(self, key: str, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        host = torch.from_numpy(np.ascontiguousarray(value))
        if self.device.type != "cuda":
            return host.to(self.device)
        self.bytes += host.nbytes
        slot = (key, tuple(host.shape), host.dtype)
        stage = self._staging.get(slot)
        if stage is None:
            stage = self._staging[slot] = torch.empty_like(host, pin_memory=True)
        stage.copy_(host)
        return stage.to(self.device, non_blocking=True)
