"""The common-slopes trainer's batch-sharded ``fit_indexed`` against the
unsharded port and against JAX's ``fit_indexed(mesh=...)``.

Two gloo ranks on the CPU (started once for the file) train the directional
MLP of JAX's spatial-training fixture (``tests/torch_port_helpers.py``: a
0.6 m grid at 8 kHz, batch 16, trained at 1.2 m: 52 training and 140
validation receivers) for 3 epochs from JAX's initialization, each rank
evaluating its half of every batch; the last rank then trains unsharded.
JAX trains on a mesh of two of the conftest's virtual CPU devices. Bounds
(ROADMAP C21): against the unsharded port, each epoch's train and valid
loss 1e-6 relative and the parameters after the fit 1e-5 relative L2,
equal on both ranks bit for bit, checkpoints from rank 0 only; against JAX,
the spatial run's bounds (1e-3 at the first epoch, 1e-2 after).
"""

import pickle

import jax
import numpy as np
import pytest

from diffgfdn_torch.data import split_by_grid_resolution
from diffgfdn_torch.parallel import spawn
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_arrays
from diffgfdn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffgfdn_tpu.training.spatial_trainer import (
    SpatialSamplingTrainer as JaxSpatialSamplingTrainer,
)
import torch_dist_workers as workers
from torch_port_helpers import cs_configs, cs_models, cs_raw_config, cs_room_path, cs_rooms
from torch_port_helpers import CS_RESOLUTION_M, rel_l2

EPOCHS = 3
LOSS_TOL, PARAM_TOL = 1e-6, 1e-5
FIRST_TOL, LAST_TOL = 1e-3, 1e-2


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_mesh")
    path = cs_room_path(tmp)
    jax_room, room = cs_rooms(path)
    jcfg, cfg = cs_configs(cs_raw_config(tmp / "sharded", True, EPOCHS))
    jcfg.train_dir = str(tmp / "jax")
    jmodel, params, _ = cs_models(jcfg, cfg, jax_room)
    train_idx, valid_idx = split_by_grid_resolution(room, CS_RESOLUTION_M)
    spec = dict(path=str(path), cfg=cfg, params=jax.tree_util.tree_map(np.asarray, params),
                resolution=CS_RESOLUTION_M, train_idx=train_idx, valid_idx=valid_idx,
                one_rank_dir=str(tmp / "one_rank"))
    with open(tmp / "spatial_mesh.pkl", "wb") as f:
        pickle.dump(spec, f)
    spawn(workers.spatial_mesh, 2, "gloo", (str(tmp),), **workers.SPAWN)
    ranks = []
    for rank in range(2):
        with open(tmp / f"spatial_mesh_rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    jtrainer = JaxSpatialSamplingTrainer(jmodel, jcfg, jax_room, grid_resolution_m=CS_RESOLUTION_M)
    jtrainer.fit_indexed(params, jax_arrays(jax_room), train_idx, valid_idx, seed=jcfg.seed,
                         mesh=jax_make_mesh(1, devices=jax.devices("cpu")[:2]))
    return dict(tmp=tmp, ranks=ranks, jax=jtrainer)


def test_batch_sharded_fit_matches_the_unsharded_port(fits, record_property):
    sharded, unsharded = fits["ranks"][0]["sharded"], fits["ranks"][1]["unsharded"]
    worst = 0.0
    for name in ("train", "valid"):
        assert len(sharded[name]) == len(unsharded[name]) == EPOCHS
        errs = [abs(a - b) / abs(b) for a, b in zip(sharded[name], unsharded[name])]
        record_property(f"{name}_loss_rel_per_epoch", [float(e) for e in errs])
        worst = max(worst, max(errs))
    params = {k: rel_l2(v, unsharded["params"][k]) for k, v in sharded["params"].items()}
    record_property("worst_param_rel_l2", float(max(params.values())))
    assert worst <= LOSS_TOL and max(params.values()) <= PARAM_TOL, (worst, params)
    other = fits["ranks"][1]["sharded"]
    assert other["train"] == sharded["train"] and other["valid"] == sharded["valid"]
    for k, v in sharded["params"].items():
        np.testing.assert_array_equal(other["params"][k], v, err_msg=k)
    ckpt = fits["tmp"] / "sharded" / f"grid_resolution={CS_RESOLUTION_M:.1f}" / "checkpoints"
    assert sorted(p.name for p in ckpt.glob("model_e*.ckpt")) == [
        f"model_e{e}.ckpt" for e in range(EPOCHS)]


def test_batch_sharded_fit_matches_jax_on_a_mesh(fits, record_property):
    sharded, jtrainer = fits["ranks"][0]["sharded"], fits["jax"]
    for name, ref in (("train", jtrainer.train_loss), ("valid", jtrainer.valid_loss)):
        assert len(ref) == EPOCHS
        errs = [abs(a - b) / abs(b) for a, b in zip(sharded[name], ref)]
        record_property(f"{name}_loss_rel_per_epoch", [float(e) for e in errs])
        assert errs[0] <= FIRST_TOL and max(errs) <= LAST_TOL, (name, errs)
