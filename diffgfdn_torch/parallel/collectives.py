"""Sharded evaluation with a replicated loss: the port's collectives.

The JAX package leaves the sharded step to GSPMD, which gives it exactly the
unsharded gradient. The port keeps that result with one rule: **shard the
model's evaluation and replicate the loss.**

* Each rank evaluates the model on its shard (its bins, its receivers): a
  :class:`Shard` cuts the inputs (:meth:`Shard.local`, padding a short block
  with its last element), and :meth:`Shard.whole` all-gathers the detached
  outputs of the other ranks and splices this rank's live block into the
  whole, trimmed to the true length (a padded element carries no gradient).
* Every rank computes the same loss on the whole. A term that does not go
  through the shard (a regularizer of parameters alone) carries its gradient
  on the shard's first rank only (:meth:`Shard.replicated`).
* :func:`all_reduce_grads` sums the parameter gradients over the ranks that
  share the parameters: the sum is the unsharded gradient up to summation
  order, the same on every rank, so the replicas stay bit-identical.

Only ``all_gather``, ``all_reduce`` and ``broadcast`` are used, which gloo and
NCCL both offer. The gather is an autograd function whose backward is this
rank's slice of the incoming gradient, with a ``vmap`` rule (the band axis
of the band-parallel trainer), so no collective runs in a backward pass.
"""

from typing import Iterable, List

import torch
import torch.distributed as dist

from .mesh import block_bounds


class Shard:
    """Rank ``index`` of ``parts`` evaluating a ``length``-long axis in
    blocks (:func:`block_bounds`), gathered over ``group`` (None: one rank,
    no collective; then :meth:`local` and :meth:`whole` return their input).

    ``of`` names the axis: "bins" (the rFFT bins of z and of the model's
    response, its last axis) or "receivers" (the items of a batch, the
    response's first axis).
    """

    def __init__(self, group, index: int, parts: int, length: int, of: str = "bins"):
        if of not in ("bins", "receivers"):
            raise ValueError(f"a shard is of 'bins' or 'receivers', not {of!r}")
        self.of = of
        self.group = group
        self.index = index
        self.parts = parts
        self.length = length
        self.start, self.stop, self.block = block_bounds(length, parts, index)
        self._positions = {}

    @property
    def trivial(self) -> bool:
        return self.group is None

    def positions(self, device: torch.device) -> torch.Tensor:
        """This rank's positions along the axis, ``block`` long: a short block
        repeats the axis's last position."""
        if device not in self._positions:
            self._positions[device] = torch.arange(
                self.start, self.start + self.block, device=device).clamp_(max=self.length - 1)
        return self._positions[device]

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (padded to ``block``)."""
        if self.trivial:
            return x
        return x.index_select(dim, self.positions(x.device))

    def whole(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's block of an output computed by :meth:`local` inputs,
        along ``dim`` (counted from the first axis), in order and trimmed to
        ``length``: the other ranks' blocks detached, this rank's live."""
        if self.trivial:
            return local
        return _GatherSplice.apply(local, self, dim)

    def response(self, model, batch: dict):
        """The model's output on the whole axis, evaluated on this rank's
        block: for "bins" z and every complex entry whose last axis is the
        bin axis (the spectra, as JAX's ``constrain`` picks them) are cut to
        the block; for "receivers" the batch's model inputs must already be
        this rank's receivers (the trainers gather them so, and the loss
        targets of the whole batch)."""
        if self.trivial:
            return model(batch)
        if self.of == "bins":
            h = model({k: self.local(v, v.dim() - 1) if self._per_bin(k, v) else v
                       for k, v in batch.items()})
            return self.whole(h, h.dim() - 1)
        return self.whole(model(batch), 0)

    def _per_bin(self, key: str, v) -> bool:
        return key == "z_values" or (torch.is_tensor(v) and v.is_complex() and v.dim() >= 1
                                     and v.shape[-1] == self.length)

    def replicated(self, value: torch.Tensor) -> torch.Tensor:
        """A term every rank computes alike: live on the first rank, detached
        on the others, so the gradient sum counts it once."""
        return value if self.trivial or self.index == 0 else value.detach()

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``all_gather`` of every rank's ``block``-long ``x`` along ``dim``,
        concatenated and trimmed to ``length`` (no autograd)."""
        flat = torch.view_as_real(x) if x.is_complex() else x
        flat = flat.contiguous()
        parts = [torch.empty_like(flat) for _ in range(self.parts)]
        dist.all_gather(parts, flat, group=self.group)
        if x.is_complex():
            parts = [torch.view_as_complex(p) for p in parts]
        return torch.cat(parts, dim).narrow(dim, 0, self.length)


class _GatherSplice(torch.autograd.Function):
    """:meth:`Shard.whole` as an autograd function: forward gathers, backward
    takes this rank's rows of the gradient (zero on its padding)."""

    @staticmethod
    def forward(local: torch.Tensor, shard: Shard, dim: int):
        return shard.gather(local.detach(), dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        shard, dim = ctx.shard, ctx.dim
        mine = g.narrow(dim, shard.start, shard.stop - shard.start)
        pad = shard.block - mine.shape[dim]
        if pad:
            shape = list(mine.shape)
            shape[dim] = pad
            mine = torch.cat([mine, mine.new_zeros(shape)], dim)
        return mine, None, None

    @staticmethod
    def vmap(info, in_dims, local, shard, dim):
        x = local.movedim(in_dims[0], 0) if in_dims[0] is not None else \
            local.expand(info.batch_size, *local.shape)
        return _GatherSplice.apply(x, shard, dim + 1), 0


def all_reduce_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks of ``group``, in one
    flat ``all_reduce`` (a missing gradient counts as zero and is set)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    views = [torch.view_as_real(p.grad) if p.grad.is_complex() else p.grad for p in params]
    flat = torch.cat([v.reshape(-1) for v in views])
    dist.all_reduce(flat, group=group)
    offset = 0
    for v in views:
        v.copy_(flat[offset:offset + v.numel()].view_as(v))
        offset += v.numel()


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor], group) -> None:
    """Overwrite ``tensors`` on every rank of ``group`` with those of its
    first rank (one flat ``broadcast`` per dtype)."""
    tensors = list(tensors)
    src = dist.get_process_group_ranks(group)[0]
    by_dtype: dict = {}
    for t in tensors:
        v = torch.view_as_real(t) if t.is_complex() else t
        by_dtype.setdefault(v.dtype, []).append(v)
    for views in by_dtype.values():
        flat = torch.cat([v.reshape(-1) for v in views])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for v in views:
            v.copy_(flat[offset:offset + v.numel()].view_as(v))
            offset += v.numel()


def all_gather_rows(x: torch.Tensor, group, sizes: List[int]) -> torch.Tensor:
    """The rows of every rank of ``group`` concatenated in rank order: rank r
    holds ``sizes[r]`` rows (``x`` here); no autograd."""
    block = max(sizes)
    pad = block - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


def shard_of(mesh, axis: str, length: int, of: str = "bins") -> Shard:
    """The :class:`Shard` of ``mesh``'s rank along the mesh axis ``axis``
    ("batch" or "band") for an axis of ``length`` bins or receivers (a
    trivial one on a mesh without process groups)."""
    if axis == "batch":
        group, index, parts = mesh.batch_group, mesh.batch_index, mesh.shape[1]
    elif axis == "band":
        group, index, parts = mesh.band_group, mesh.band_index, mesh.shape[0]
    else:
        raise ValueError(f"unknown mesh axis {axis!r}")
    return Shard(group, index, parts, length, of)
