"""The (band, batch) grid of ranks (port of ``parallel/mesh.py``).

The JAX package lays its devices out as a two-axis mesh, ``band`` for the
octave-band models of a group and ``batch`` for the receivers of a batch
(data parallelism), under one controller. Here each device is a process of
one ``torch.distributed`` group, and :class:`Mesh` lays the ranks out the
same way: rank r sits at (r // batch, r % batch). Each rank keeps two
process groups, its row along the batch axis (the ranks that share its
bands) and its column along the band axis.

Every sharded path of the port (``parallel/freq_parallel.py``,
``parallel/band_parallel.py``, ``training/spatial_trainer.py``) takes a
:class:`Mesh`; :func:`make_mesh` with no process group initialized gives the
mesh of one rank, under which the paths run unsharded and call no
collective. Processes come from ``torchrun``
(:func:`init_process_group_from_env`) or from :func:`spawn`.
"""

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# batch entries that every receiver shares: whole on every rank
SHARED_PREFIXES = ("z_values", "mesh_2d", "sph_directions")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a (band, batch) grid, seen from one of them.

    ``index``: this rank's place in the grid, row-major (its global rank:
    a grid covers the first ranks of the group); ``band_group`` /
    ``batch_group``: the process groups of this rank's column (same batch
    index, every band index) and row (same band index, every batch index),
    None on a mesh of one process.
    """

    shape: Tuple[int, int]
    index: int = 0
    band_group: Any = None
    batch_group: Any = None
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def band_index(self) -> int:
        return self.index // self.shape[1]

    @property
    def batch_index(self) -> int:
        return self.index % self.shape[1]

    @property
    def distributed(self) -> bool:
        """True when the mesh has process groups: its paths run their
        collectives, even on a grid of one rank."""
        return self.batch_group is not None


def mesh_shape(num_bands: int, world: int) -> Tuple[int, int]:
    """(band, batch) of ``world`` ranks: ``num_bands`` clipped to the largest
    number that divides ``world``, as JAX's ``make_mesh`` clips it."""
    band = next(c for c in range(min(max(num_bands, 1), world), 0, -1) if world % c == 0)
    return band, world // band


def make_mesh(num_bands: int = 1, world_size: Optional[int] = None) -> Optional[Mesh]:
    """Mesh of shape (band, batch) over the first ``world_size`` ranks of the
    initialized process group (all of them by default).

    ``num_bands`` ranks go to the band axis, clipped to the largest number
    that divides the ranks, as JAX's ``make_mesh`` clips it; the rest go to
    the batch axis. Every rank of the process group must call this, in the
    same order (each call makes the grid's process groups); a rank outside
    the first ``world_size`` gets None. With no process group initialized,
    the mesh of one process (no collectives).
    """
    if not dist.is_initialized():
        if world_size not in (None, 1):
            raise ValueError(f"a mesh of {world_size} ranks needs an initialized process group")
        return Mesh((1, 1))
    world = dist.get_world_size()
    n = world if world_size is None else int(world_size)
    if not 1 <= n <= world:
        raise ValueError(f"world_size {n} outside 1..{world}")
    band, batch = mesh_shape(num_bands, n)
    grid = np.arange(n).reshape(band, batch)
    rows = [dist.new_group([int(r) for r in row]) for row in grid]
    cols = [dist.new_group([int(r) for r in col]) for col in grid.T]
    rank = dist.get_rank()
    if rank >= n:
        return None
    i, j = divmod(rank, batch)
    return Mesh((band, batch), rank, cols[j], rows[i], dist.get_backend())


def band_sizes(num_bands: int, parts: int) -> List[int]:
    """The bands of each of ``parts`` band ranks: contiguous runs whose sizes
    differ by at most one, none empty."""
    if num_bands < parts:
        raise ValueError(f"{num_bands} bands over a band axis of {parts} ranks")
    q, r = divmod(num_bands, parts)
    return [q + (i < r) for i in range(parts)]


def band_slice(num_bands: int, mesh: Mesh) -> slice:
    """The bands of ``mesh``'s rank (:func:`band_sizes`)."""
    sizes = band_sizes(num_bands, mesh.shape[0])
    start = sum(sizes[:mesh.band_index])
    return slice(start, start + sizes[mesh.band_index])


def block_bounds(n: int, parts: int, index: int) -> Tuple[int, int, int]:
    """(start, stop, block) of shard ``index`` of ``n`` items over ``parts``
    ranks, as GSPMD lays out an axis that ``parts`` need not divide: blocks
    of ceil(n / parts), the last ones short or empty."""
    block = -(-n // parts)
    start = min(index * block, n)
    return start, min(start + block, n), block


def batch_slice(n: int, mesh: Mesh) -> slice:
    """The receivers of ``mesh``'s rank among ``n``: its block along the batch axis."""
    start, stop, _ = block_bounds(n, mesh.shape[1], mesh.batch_index)
    return slice(start, stop)


def shard_batch_dict(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's receivers of a batch: each entry's leading axis sliced by
    :func:`batch_slice`, the entries every receiver shares (``z_values``,
    ``mesh_2d``, ``sph_directions``) whole."""
    return {k: v if k.startswith(SHARED_PREFIXES) else v[batch_slice(len(v), mesh)]
            for k, v in batch.items()}


def init_process_group_from_env(backend: str = "nccl") -> Optional[torch.device]:
    """The process group of a ``torchrun`` launch, from its environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
    and this rank's device: ``cuda:LOCAL_RANK`` under NCCL (the default),
    the CPU under gloo. None, and no group, outside such a launch."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if backend == "nccl":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method="env://")
    return device


def run_rank(rank: int, fn: Callable, world: int, backend: str, store_path: str,
             args: Sequence = ()) -> None:
    """Run ``fn(rank, world, *args)`` in this process as rank ``rank`` of a
    process group of ``world`` (``backend``) that meets through a
    ``FileStore`` at ``store_path`` (on ``cuda:rank`` under NCCL), then leave
    the group. :func:`spawn` runs it in each new process; a group of one
    rank can run it in the calling process."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "nccl", args: Sequence = (),
          start_method: str = "spawn", preload: Sequence[str] = ()) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes, each a rank
    of one process group (``backend``) that meets through a ``FileStore`` in
    a temporary directory. Under NCCL rank r runs on ``cuda:r``; ``fn``
    chooses its own device under gloo. ``fn`` must be importable by name (a
    module-level function). Returns when every rank has ended; raises if one
    failed.

    ``start_method="forkserver"`` forks the ranks from one server process
    that imported the modules named in ``preload`` once (set before the
    server's first start), so that later groups start without importing
    them again."""
    if start_method == "forkserver" and preload:
        torch.multiprocessing.get_context("forkserver").set_forkserver_preload(list(preload))
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            run_rank, args=(fn, world, backend, os.path.join(tmp, "store"), tuple(args)),
            nprocs=world, join=True, start_method=start_method)
