"""The band-parallel trainer over (band, batch) grids of ranks against the
one-rank trainer and against JAX's ``BandParallelTrainer`` on the same mesh.

Four gloo ranks on the CPU, started once for the file (module fixture), run
``tests/torch_dist_workers.py``: the meshes (2, 1) and (1, 2) on the first
two ranks while the last runs the one-rank trainer, then (2, 2) on all four.
Each does one step and a 2-epoch ``fit_indexed`` from the same parameters
(each band's seed on the group's first model, as JAX builds its one model),
on the subband fixture of ``tests/test_torch_subband.py`` (8 kHz, nfft 2^12,
24 receivers, the 500 / 1000 Hz group, batch 8); then a checkpoint of each
band written by its owner, read back by the band's ranks and continued under
(2, 2). JAX's trainer runs here on four of the conftest's virtual CPU
devices, on the joint (2, 2) mesh of its multi-device exercise (the smaller
meshes are held to the one-rank trainer, which ``tests/test_torch_subband.py``
holds to JAX's). Bounds (ROADMAP C21): against the one-rank port, losses
1e-6 relative, gradients 1e-5, the parameters after one Adam step 1e-6 and
after the 2-epoch fit 1e-5, bit for bit across a band's batch ranks; against
JAX, C3's bounds on the losses (1e-3) and gradients (1e-2), and the Adam
update within the gradients' bound (C3's 1e-6 is on identical gradients,
``tests/test_torch_optim.py``).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffgfdn_torch.parallel import spawn
from diffgfdn_torch.training import build_gfdn_model
from diffgfdn_torch.training.solver import subband_resp
from diffgfdn_torch.utils.params import jax_params_from_torch, stack_jax_trees
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import gather_batch
from diffgfdn_tpu.parallel import BandParallelTrainer as JaxBandParallelTrainer
from diffgfdn_tpu.parallel.mesh import band_sharding
from diffgfdn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffgfdn_tpu.training.build import build_gfdn_model as jax_build_gfdn_model
import torch_dist_workers as workers
from torch_port_helpers import (
    BANDS,
    rel_l2,
    subband_configs,
    subband_room_path,
    subband_rooms,
    SUBBAND_NFFT,
)

IDX = np.arange(8)
LOSS_TOL, GRAD_TOL, ADAM_TOL, FIT_TOL = 1e-6, 1e-5, 1e-6, 1e-5
JAX_LOSS_TOL, JAX_GRAD_TOL = 1e-3, 1e-2


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("band_mesh")
    monkeypatch = pytest.MonkeyPatch()
    path = subband_room_path(tmp)
    jax_room, port_room = subband_rooms(path)
    jcfgs, cfgs = subband_configs(monkeypatch, path, tmp, spectral_weight=0.0)
    monkeypatch.undo()
    jcfgs, cfgs = jcfgs[:2], cfgs[:2]
    resps = np.stack([subband_resp(c) for c in cfgs])
    max_ir_ms = float(np.max(jax_room.common_decay_times)) * 1e3
    # each band's parameters from its own seed, on the group's first model
    trees = []
    for cfg in cfgs:
        model = build_gfdn_model(dataclasses.replace(cfgs[0], seed=cfg.seed),
                                 port_room.common_decay_times, port_room.band_centre_hz,
                                 device="cpu")
        trees.append(jax_params_from_torch(model))
    spec = dict(path=str(path), nfft=SUBBAND_NFFT, cdt=port_room.common_decay_times,
                band_centres=BANDS, cfg=cfgs[0], resps=resps, max_ir_ms=max_ir_ms,
                params=stack_jax_trees(trees), idx=IDX, train_idx=np.arange(16),
                valid_idx=np.arange(16, 24), seed=cfgs[0].seed)
    with open(tmp / "band_mesh.pkl", "wb") as f:
        pickle.dump(spec, f)
    spawn(workers.band_meshes, 4, "gloo", (str(tmp),), **workers.SPAWN)
    ranks = []
    for rank in range(4):
        with open(tmp / f"band_mesh_rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(spec=spec, ranks=ranks, one_rank=ranks[3]["one_rank"], jcfg=jcfgs[0],
                jax_room=jax_room, resps=resps, max_ir_ms=max_ir_ms)


def _band_rows(per_rank, key):
    """{global band: (rank, array row)} of a stacked per-band result."""
    rows = {}
    for rank, r in enumerate(per_rank):
        lo, hi = r["bands"]
        for b in range(lo, hi):
            rows.setdefault(b, []).append((rank, {k: v[b - lo] for k, v in r[key].items()}
                                           if isinstance(r[key], dict) else r[key][b - lo]))
    return rows


@pytest.mark.parametrize("name", list(workers.BAND_MESHES))
def test_band_mesh_matches_the_one_rank_trainer(meshes, name, record_property):
    per_rank = [r[name] for r in meshes["ranks"] if name in r]
    one = meshes["one_rank"]
    assert per_rank[0]["mesh"] == {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}[name]
    worst = dict(loss=0.0, grad=0.0, adam=0.0, fit=0.0)
    for b, rows in _band_rows(per_rank, "totals").items():
        for _, total in rows:
            worst["loss"] = max(worst["loss"], abs(total - one["totals"][b]) / abs(one["totals"][b]))
    for key, tol_key in (("grads", "grad"), ("adam", "adam"), ("fit", "fit")):
        for b, rows in _band_rows(per_rank, key).items():
            first = rows[0][1]
            for _, state in rows:
                for k, v in state.items():
                    np.testing.assert_array_equal(v, first[k], err_msg=f"{name} {key} {k}")
                    worst[tol_key] = max(worst[tol_key], rel_l2(v, one[key][k][b]))
    for r in per_rank:
        hist = r["history"]
        assert hist.shape == one["history"].shape == (2, 2)
        worst["loss"] = max(worst["loss"], float(np.max(np.abs(hist - one["history"])
                                                        / np.abs(one["history"]))))
        np.testing.assert_array_equal(hist, per_rank[0]["history"])
        np.testing.assert_array_equal(r["valid"], per_rank[0]["valid"])
    for k, v in worst.items():
        record_property(f"worst_{k}", float(v))
    assert worst["loss"] <= LOSS_TOL and worst["grad"] <= GRAD_TOL
    assert worst["adam"] <= ADAM_TOL and worst["fit"] <= FIT_TOL, worst


def test_band_mesh_matches_jax_on_the_joint_mesh(meshes, record_property):
    """(2, 2), the joint band x batch mesh of JAX's multi-device exercise:
    the step's losses and gradients within C3's bounds; the Adam update,
    whose gradients differ by that much, within the gradient bound."""
    spec, jax_room = meshes["spec"], meshes["jax_room"]
    arrays = jax_arrays(jax_room)
    jmesh = jax_make_mesh(2, devices=jax.devices("cpu")[:4])
    assert jmesh.devices.shape == (2, 2)
    jax_model = jax_build_gfdn_model(meshes["jcfg"], common_decay_times=jax_room.common_decay_times,
                                     band_centre_hz=jax_room.band_centre_hz,
                                     use_pallas_inverse=False)
    jtrainer = JaxBandParallelTrainer(jax_model, meshes["jcfg"].trainer_config, meshes["resps"],
                                      2, max_ir_len_ms=meshes["max_ir_ms"], mesh=jmesh)
    params = jax.device_put(spec["params"], band_sharding(jmesh))
    jtrainer.optimizer = jtrainer._make_optimizer(jax.tree_util.tree_map(lambda x: x[0], params))
    opt_state = jax.vmap(jtrainer.optimizer.init)(params)
    jtrainer._build_step()
    jtrainer.precompute_band_target_features(arrays)
    key = jax.random.PRNGKey(3)
    step = jax.jit(jtrainer._make_indexed_step())
    new_params, _, totals, _ = step(params, opt_state, jtrainer.upload_arrays(arrays),
                                    jtrainer._band_feats, jtrainer._band_resps_dev,
                                    jnp.asarray(IDX, jnp.int32), key, jnp.ones(2, jnp.float32))
    batch = gather_batch(arrays, IDX)
    feats = {k: v[:, IDX] for k, v in jtrainer._band_feats.items()}
    grads = jax.jit(jax.vmap(jax.grad(
        lambda pb, fb, rb: jtrainer._loss_fn(pb, {**batch, **fb}, rb, key)[0])))(
        params, feats, jtrainer.band_responses)
    start = flax_tree_np(spec["params"])
    update = {k: v - start[k] for k, v in flax_tree_np(new_params).items()}
    grads = flax_tree_np(grads)
    per_rank = [r["2x2"] for r in meshes["ranks"]]
    worst = dict(loss=0.0, grad=0.0, update=0.0)
    for b, rows in _band_rows(per_rank, "totals").items():
        for _, total in rows:
            worst["loss"] = max(worst["loss"],
                                abs(total - float(totals[b])) / abs(float(totals[b])))
    for b, rows in _band_rows(per_rank, "grads").items():
        for _, state in rows:
            for k, v in state.items():
                worst["grad"] = max(worst["grad"], rel_l2(v, grads[k][b]))
    for b, rows in _band_rows(per_rank, "adam").items():
        for _, state in rows:
            for k, v in state.items():
                worst["update"] = max(worst["update"],
                                      rel_l2(v - start[k][b], update[k][b]))
    for k, v in worst.items():
        record_property(f"worst_{k}", float(v))
    assert worst["loss"] <= JAX_LOSS_TOL and worst["grad"] <= JAX_GRAD_TOL
    assert worst["update"] <= JAX_GRAD_TOL, worst


def flax_tree_np(tree) -> dict:
    """A JAX band-stacked tree as the port's {name: (bands, ...)} numpy state."""
    from diffgfdn_torch.utils.params import torch_state_from_jax

    state = torch_state_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    return {k: v.numpy() for k, v in state.items()}


def test_band_checkpoints_restore_and_continue_under_the_mesh(meshes):
    per_rank = [r["checkpoint"] for r in meshes["ranks"]]
    assert all(r["equal"] for r in per_rank)
    assert sorted({r["bands"] for r in per_rank}) == [(0, 1), (1, 2)]
    for r in per_rank:
        assert np.isfinite(r["continued"]).all()
    by_band = {}
    for r in per_rank:
        by_band.setdefault(r["bands"], []).append(r["continued"])
    for rows in by_band.values():
        np.testing.assert_array_equal(rows[0], rows[1])
