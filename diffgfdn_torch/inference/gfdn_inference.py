"""GFDN inference: serve RIRs from a trained checkpoint (port of ``inference/gfdn_inference.py``).

Given a checkpoint (the JAX package's format, ``training/checkpoints.py``)
and dataset receiver indices, run the model over the receivers' positions
and irfft the transfer function to RIRs of shape (B, nfft).
"""

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..config.schema import DiffGFDNConfig
from ..data.batching import arrays_from_room_dataset
from ..data.room_dataset import RoomDataset
from ..training.build import build_gfdn_model
from ..training.checkpoints import load_latest_checkpoint
from ..utils.device import resolve_device
from ..utils.params import load_jax_params

# the batch entries DiffGFDNVarReceiverPos reads
MODEL_INPUTS = ("z_values", "listener_position", "norm_listener_position",
                "target_early_response")


def make_rir_synthesis_fn(
    model: torch.nn.Module, reduced_pole_radius: float = 1.0
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """``synth(batch) -> RIRs (B, nfft)`` float32, on the batch's device.

    irffts the model's transfer function and undoes sampling outside the
    unit circle with a growing exponential. Forward only: no autograd graph.
    """

    @torch.no_grad()
    def synth(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = model(batch)
        n = 2 * (h.shape[-1] - 1)
        rir = torch.fft.irfft(h, n, dim=-1)
        if reduced_pole_radius != 1.0:
            growth = torch.tensor(1.0 / reduced_pole_radius, dtype=torch.float32)
            rir = rir * torch.pow(
                growth, torch.arange(n, dtype=torch.float32)
            ).to(rir.device)
        return rir

    return synth


class InferDiffGFDN:
    """Serve RIRs at dataset receiver positions from a trained checkpoint.

    ``params``: a flax-layout parameter tree (as a checkpoint holds it);
    None loads the newest checkpoint under ``trainer_config.train_dir``.
    ``device`` defaults to CUDA and raises without a card unless the caller
    passes ``device="cpu"``.
    """

    def __init__(
        self,
        config: DiffGFDNConfig,
        room_data: RoomDataset,
        variant: str = "var_receiver",
        params: Optional[Dict] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        tc = config.trainer_config
        if tc.subband_process_config is not None:
            raise NotImplementedError(
                "subband models (subband_process_config) are not ported yet (ROADMAP A11)"
            )
        self.config = config
        self.room_data = room_data
        self.model = build_gfdn_model(
            config,
            common_decay_times=room_data.common_decay_times,
            band_centre_hz=room_data.band_centre_hz,
            variant=variant,
            device=self.device,
        )
        if params is None:
            params = load_latest_checkpoint(tc.train_dir, tc.max_epochs)
            if params is None:
                raise FileNotFoundError(f"no checkpoint under {tc.train_dir}")
        load_jax_params(self.model, params)
        self.model.eval()
        self._synth = make_rir_synthesis_fn(self.model, tc.reduced_pole_radius)
        self.arrays = arrays_from_room_dataset(
            room_data,
            new_sampling_radius=(
                None if tc.reduced_pole_radius == 1.0 else 1.0 / tc.reduced_pole_radius
            ),
        )

    def _device_batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """The model's inputs only: the late and full target planes are never read."""
        batch = {k: getattr(self.arrays, k)[idx] for k in MODEL_INPUTS if k != "z_values"}
        batch["z_values"] = self.arrays.z_values  # shared by every receiver
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def rirs_at(self, rec_indices: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """Synthesize RIRs (len(rec_indices), nfft) at the dataset receiver indices.

        The last batch is padded to ``batch_size`` with its first index and
        trimmed, so every call runs full batches.
        """
        rec_indices = np.asarray(rec_indices)
        outs = []
        for k in range(0, len(rec_indices), batch_size):
            idx = rec_indices[k : k + batch_size]
            n_real = len(idx)
            if n_real < batch_size:
                idx = np.concatenate([idx, idx[:1].repeat(batch_size - n_real)])
            rir = self._synth(self._device_batch(idx))
            outs.append(rir[:n_real].cpu().numpy())
        return np.concatenate(outs, axis=0)
