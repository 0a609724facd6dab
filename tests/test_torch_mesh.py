"""The port's (band, batch) grid of ranks against JAX's device mesh.

No process group is started here: the grid's shape and each rank's shares
are pure functions of the world, the band count and the rank, held against
``diffgfdn_tpu.parallel.mesh`` on the conftest's eight virtual CPU devices
(the shape and band clipping of ``make_mesh`` for worlds and band counts
1-8; each rank's ``shard_batch_dict`` and band block against the
``addressable_shards`` that JAX places on the device of the same index).
"""

import jax
import numpy as np
import pytest

from diffgfdn_torch.parallel import band_slice, batch_slice, make_mesh, Mesh, shard_batch_dict
from diffgfdn_torch.parallel.mesh import block_bounds, mesh_shape
from diffgfdn_tpu.parallel.mesh import band_sharding
from diffgfdn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffgfdn_tpu.parallel.mesh import shard_batch_dict as jax_shard_batch_dict


@pytest.mark.parametrize("world", range(1, 9))
def test_mesh_shape_and_band_clipping_match_jax(world):
    devices = jax.devices("cpu")[:world]
    for num_bands in range(1, 9):
        assert mesh_shape(num_bands, world) == jax_make_mesh(num_bands, devices).devices.shape


def test_mesh_without_a_process_group_is_one_rank():
    mesh = make_mesh(8)
    assert mesh.shape == (1, 1) and not mesh.distributed
    with pytest.raises(ValueError, match="initialized process group"):
        make_mesh(1, world_size=2)


def _addressable(arr) -> dict:
    """{device id: numpy block} of a sharded JAX array."""
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("world,num_bands", [(8, 1), (8, 2), (8, 4), (4, 2), (6, 3), (2, 2)])
def test_shard_batch_dict_matches_jax_addressable_shards(world, num_bands):
    devices = jax.devices("cpu")[:world]
    jmesh = jax_make_mesh(num_bands, devices)
    shape = jmesh.devices.shape
    rng = np.random.RandomState(world * 10 + num_bands)
    items = 3 * shape[1]
    batch = {
        "listener_position": rng.randn(items, 3).astype(np.float32),
        "target_edc_db": rng.randn(items, 5).astype(np.float32),
        "z_values": np.exp(1j * np.linspace(0, np.pi, 9)).astype(np.complex64),
        "mesh_2d": rng.randn(4, 2).astype(np.float32),
    }
    placed = jax_shard_batch_dict(batch, jmesh)
    flat_devices = list(jmesh.devices.flat)
    for rank in range(world):
        mesh = Mesh(shape, rank)
        mine = shard_batch_dict(batch, mesh)
        device_id = flat_devices[rank].id
        for k, v in placed.items():
            np.testing.assert_array_equal(mine[k], _addressable(v)[device_id], err_msg=k)
        assert batch_slice(items, mesh) == slice(*block_bounds(items, shape[1],
                                                               mesh.batch_index)[:2])


@pytest.mark.parametrize("world,num_bands,bands", [(8, 2, 4), (8, 4, 8), (4, 2, 2), (6, 3, 6)])
def test_band_slice_matches_jax_band_sharding(world, num_bands, bands):
    """Where the band axis divides the bands (JAX places no other), each
    rank's bands are the block JAX puts on its device."""
    jmesh = jax_make_mesh(num_bands, jax.devices("cpu")[:world])
    stacked = jax.device_put(np.arange(bands, dtype=np.float32), band_sharding(jmesh))
    blocks = _addressable(stacked)
    for rank, device in enumerate(jmesh.devices.flat):
        sl = band_slice(bands, Mesh(jmesh.devices.shape, rank))
        np.testing.assert_array_equal(np.arange(bands)[sl], blocks[device.id])


def test_uneven_shares():
    """Bands split in runs differing by at most one, none empty; a batch or
    bin axis in GSPMD's ceil blocks, the last short."""
    for bands, parts in ((5, 4), (3, 2), (7, 3)):
        sizes = [len(range(bands)[band_slice(bands, Mesh((parts, 1), i))]) for i in range(parts)]
        assert sum(sizes) == bands and max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert [block_bounds(1025, 3, i) for i in range(3)] == [(0, 342, 342), (342, 684, 342),
                                                              (684, 1025, 342)]
    assert block_bounds(65537, 2, 1) == (32769, 65537, 32769)
    with pytest.raises(ValueError, match="bands over a band axis"):
        band_slice(1, Mesh((2, 1), 0))


def test_graphed_steps_refuse_gloo_collectives_on_cuda_tensors():
    """A trainer whose steps hold gloo's collectives cannot graph them on the
    card: ``run_step`` raises before any CUDA call unless ``scan_epochs`` is
    False (no eager fallback); NCCL's and no collective are graphed."""
    import torch

    from diffgfdn_torch.training.scan import GraphedSteps

    class Steps(GraphedSteps):
        pass

    steps = Steps()
    steps.init_graphs(torch.device("cuda"))  # makes no CUDA call
    steps.collective_backend = "gloo"
    ran = []
    with pytest.raises(RuntimeError, match="cannot capture gloo"):
        steps.run_step("train", lambda idx: ran.append(idx), idx=torch.zeros(1))
    steps.scan_epochs = False
    steps.run_step("train", lambda idx: ran.append(idx), idx=torch.zeros(1))
    assert len(ran) == 1
