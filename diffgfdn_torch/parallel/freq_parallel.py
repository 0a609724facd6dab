"""Training with the rFFT bin axis sharded (port of ``parallel/freq_parallel.py``).

A single-position fit has one receiver and the whole unit circle as its
batch, so its only axis to share out is the ~65k rFFT bins. Each bin's
(D Gamma^-1 - A) solve is independent: each rank evaluates the model on its
block of the bins (the axis padded to a multiple of the ranks with a
repeated last z, as GSPMD pads it in the JAX package), the blocks are
gathered and trimmed back to F bins, and every rank takes the same loss on
the whole spectrum against the whole targets (``parallel/collectives.py``).
The gradients are summed over the ranks and every rank steps its optimizer:
the parameters stay replicated, bit for bit.

JAX constrains each target spectrum whose last axis is the bin axis to the
same sharding; the values are the whole spectrum either way, and here each
rank holds them whole, as its replicated loss reads them.
"""

from typing import Callable, Dict, Tuple

import torch

from .collectives import all_reduce_grads, Shard, shard_of
from .mesh import Mesh


def make_freq_sharded_step(
    model: torch.nn.Module,
    loss_fn: Callable[[Dict[str, torch.Tensor], Shard], Tuple[torch.Tensor, Dict]],
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    freq_axis: str = "batch",
) -> Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """One optimizer step with the bin axis sharded over the mesh axis ``freq_axis``.

    ``loss_fn(batch, shard) -> (total, aux)`` evaluates the model through
    ``shard.response(model, batch)`` (its bins, gathered whole) and takes the
    loss on the whole; a term that does not go through the shard goes through
    ``shard.replicated``. Returns ``run(batch) -> (total, aux)``, detached:
    zero the gradients, the loss and its backward, the gradients summed over
    the ranks, the optimizer's step.
    """
    group = mesh.batch_group if freq_axis == "batch" else mesh.band_group
    params = [p for p in model.parameters() if p.requires_grad]
    shards: Dict[int, Shard] = {}

    def run(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        num_bins = batch["z_values"].shape[0]
        if num_bins not in shards:
            shards[num_bins] = shard_of(mesh, freq_axis, num_bins, "bins")
        for p in params:
            p.grad = None
        total, aux = loss_fn(batch, shards[num_bins])
        total.backward()
        if mesh.distributed:
            all_reduce_grads(params, group)
        optimizer.step()
        return total.detach(), {k: v.detach() for k, v in aux.items()}

    return run
