"""Splits, batch order and the optimizer of the port against the JAX package.

* the hold-out, train / valid splits, the epoch permutations and the padded
  and exact-validation batches are identical for the same seed;
* the optimizer labels of every parameter (on its flax path) equal
  ``diffgfdn_tpu.training.optim.label_params`` for both slice presets;
* one Adam step per label group on identical gradients gives optax's
  update to <= 1e-6, before and after the step decay's boundary (10 epochs).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from diffgfdn_torch.config import preset_config
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import fixed_test_split, index_batches, train_valid_split
from diffgfdn_torch.training import (
    build_gfdn_model,
    exact_valid_batches,
    make_optimizer,
    padded_batches,
    param_labels,
)
from diffgfdn_torch.utils.params import flax_path, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data import batching as jax_batching
from diffgfdn_tpu.training import optim as jax_optim
from diffgfdn_tpu.training import trainer as jax_trainer
from torch_port_helpers import jax_model_and_params, raw_config, rooms

UPDATE_TOL = 1e-6


@pytest.mark.parametrize("num_items,batch", [(96, 32), (86, 32), (10, 4), (3, 8)])
def test_splits_permutations_and_batches_equal_jax(num_items, batch):
    test, rest = fixed_test_split(num_items, 0.1, 4314)
    jtest, jrest = jax_batching.fixed_test_split(num_items, 0.1, 4314)
    np.testing.assert_array_equal(test, jtest)
    np.testing.assert_array_equal(rest, jrest)
    train, valid = train_valid_split(rest, 0.8, seed=235265)
    jtrain, jvalid = jax_batching.train_valid_split(jrest, 0.8, seed=235265)
    np.testing.assert_array_equal(train, jtrain)
    np.testing.assert_array_equal(valid, jvalid)
    rng, jrng = np.random.RandomState(1234), np.random.RandomState(1234)
    for _ in range(3):  # the trainers' epoch permutations
        perm = train[rng.permutation(len(train))]
        jperm = jtrain[jrng.permutation(len(jtrain))]
        got = list(padded_batches(perm, batch))
        ref = list(jax_trainer.padded_batches(jperm, batch))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    (full, rem), (jfull, jrem) = (exact_valid_batches(valid, batch),
                                  jax_trainer.exact_valid_batches(jvalid, batch))
    np.testing.assert_array_equal(np.asarray(full).reshape(-1), np.asarray(jfull).reshape(-1))
    np.testing.assert_array_equal(rem, jrem)
    # the exported IR batches: iterate_batches' order, tail dropped
    got = [b for b in index_batches(train, batch, shuffle=True, seed=7)]
    jidx = train[np.random.RandomState(7).permutation(len(train))]
    assert len(got) == len(train) // batch
    for k, b in enumerate(got):
        np.testing.assert_array_equal(b, jidx[k * batch : (k + 1) * batch])


@pytest.mark.parametrize("name", ["fullband_grid_colorless", "three_room_example"])
def test_parameter_labels_equal_jax(tmp_path, name):
    cfg = preset_config(name)
    jcfg = JaxDiffGFDNConfig.model_validate(_preset_raw(name))
    room_svf = cfg.output_filter_config.use_svfs
    jax_room, port_room = rooms(tmp_path, room_svf, 512)
    _, params = jax_model_and_params(jcfg, jax_room, 2)
    model = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                             device="cpu")
    ref = {
        "/".join(p.key for p in path): label
        for path, label in jax.tree_util.tree_leaves_with_path(jax_optim.label_params(params))
    }
    got = {"/".join(["params"] + flax_path(k)[0]): v for k, v in param_labels(model).items()}
    assert got == ref
    assert set(got.values()) >= {"io", "other"}


def _preset_raw(name):
    from diffgfdn_torch.config.presets import PRESETS

    raw = dict(PRESETS[name])
    raw["sample_rate"] = 8000.0  # the synthetic test room; widths stay the preset's
    return raw


def test_adam_step_matches_optax_across_the_step_decay(tmp_path, record_property):
    """Identical gradients per label group; steps before and after the
    boundary at 10 epochs (one step per epoch, count offset 9)."""
    raw = raw_config(tmp_path, svf=False, zero_coupling=False)
    raw["trainer_config"].update(lr=3e-3, io_lr=2e-2, coupling_angle_lr=5e-2)
    jax_room, port_room = rooms(tmp_path, False, 512)
    jcfg = JaxDiffGFDNConfig.model_validate(raw)
    _, params = jax_model_and_params(jcfg, jax_room, 2)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, port_room.common_decay_times, port_room.band_centre_hz,
                             device="cpu")
    load_jax_params(model, params)
    optimizer, scheduler = make_optimizer(cfg.trainer_config, model, 1, count_offset=9)
    assert {g["label"] for g in optimizer.param_groups} == {"coupling", "io", "other"}
    jopt = jax_optim.make_optimizer(jcfg.trainer_config, params, 1, count_offset=9)
    jstate = jopt.init(params)
    rng = np.random.RandomState(0)
    worst = 0.0
    for step in range(2):  # step 0 at the full rate, step 1 after the decay
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*np.shape(x)).astype(np.float32), params
        )
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(grads))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        for name, p in model.named_parameters():
            keys, transpose = flax_path(name)
            path = tuple(jax.tree_util.DictKey(k) for k in ["params"] + keys)
            g = torch.from_numpy(np.asarray(flat_g[path]))
            p.grad = g.T.contiguous() if transpose else g
        optimizer.step()
        scheduler.step()
        flat_u = dict(jax.tree_util.tree_leaves_with_path(updates))
        for name, p in model.named_parameters():
            keys, transpose = flax_path(name)
            ref = np.asarray(flat_u[tuple(jax.tree_util.DictKey(k) for k in ["params"] + keys)])
            got = (p.detach() - before[name]).numpy()
            got = got.T if transpose else got
            worst = max(worst, float(np.abs(got - ref).max()))
            assert np.abs(got - ref).max() <= UPDATE_TOL, (step, name)
    record_property("max_update_abs_diff", worst)
    assert optimizer.param_groups[0]["lr"] == pytest.approx(
        0.1 * {"coupling": 5e-2, "io": 2e-2, "other": 3e-3}[optimizer.param_groups[0]["label"]]
    )
