"""Host batches in the port against the JAX package: ``iterate_batches`` /
``num_batches`` and ``GFDNTrainer.fit``.

The batch iterator must draw the JAX package's batches exactly (shuffled or
not, the tail dropped, short or padded). ``GFDNTrainer.fit`` trains on
batches made on the host in both packages from one start (the JAX
parameters carried across), at toy scale: fs 8 kHz, nfft 2048, 24
synthetic receivers (19 train: 2 batches of 8; 5 valid: one short batch),
the EDC mask off. Bounds (ROADMAP C3's): each epoch's train and valid losses
and each term within 1e-3 relative, the final parameters within 1e-2
relative L2 a leaf; the checkpoints written and the history lengths equal.
The cases: scalar heads on the raw target spectra, with early stopping
forced after the second epoch (tolerance 1e9, patience 1: both packages
stop there); SVF heads on precomputed target features; the directional
trainer's inherited ``fit`` for one epoch (ambi order 1). The other two
head-and-branch pairs are marked slow.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import arrays_from_room_dataset, arrays_from_spatial_dataset
from diffgfdn_torch.data import generate_three_room_pickle, iterate_batches, num_batches
from diffgfdn_torch.data import ThreeRoomDataset
from diffgfdn_torch.losses import make_decay_envelopes
from diffgfdn_torch.training import build_gfdn_model, DirectionalGFDNTrainer, GFDNTrainer
from diffgfdn_torch.utils.params import jax_params_from_torch, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset
from diffgfdn_tpu.data.batching import arrays_from_room_dataset as jax_arrays
from diffgfdn_tpu.data.batching import iterate_batches as jax_iterate_batches
from diffgfdn_tpu.data.batching import num_batches as jax_num_batches
from diffgfdn_tpu.data.batching import train_valid_split
from diffgfdn_tpu.data.spatial_dataset import arrays_from_spatial_dataset as jax_spatial_arrays
from diffgfdn_tpu.losses.spatial import make_decay_envelopes as jax_make_decay_envelopes
from diffgfdn_tpu.ops.basic import ms_to_samps
from diffgfdn_tpu.training.trainer import DirectionalGFDNTrainer as JaxDirectionalGFDNTrainer
from diffgfdn_tpu.training.trainer import GFDNTrainer as JaxGFDNTrainer
from torch_port_helpers import (
    BANDS,
    DECAY_TIMES,
    directional_raw_config,
    FS,
    jax_directional_model_and_params,
    jax_model_and_params,
    raw_config,
    rel_l2,
    spatial_rooms,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (a module fixture)

NFFT = 2 ** 11
BATCH = 8
RECEIVERS_PER_ROOM = 8  # 24 receivers: 19 train, 5 valid
# per epoch: ROADMAP C3's trainer bound after the first, the multi-epoch runs'
# 1e-2 after the second (test_torch_c1_fullband_losses.py): from the same
# start the trajectories part slowly; the port's own fit and fit_indexed part
# alike when their early spectra differ by rounding (scipy's rfft on the host,
# torch's on the device), and agree bit for bit when they do not
# (test_fit_steps_as_fit_indexed_on_the_same_batches)
LOSS_TOL = (1e-3, 1e-2)
PARAM_TOL = 1e-2
RADIUS = 1.001  # the directional case's z radius


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(JAX dataset, port dataset) of 24 receivers, per-band decay times."""
    tmp = tmp_path_factory.mktemp("host_batches")
    path = generate_three_room_pickle(tmp / "srirs.pkl", fs=FS,
                                      num_rec_per_room=RECEIVERS_PER_ROOM, rir_len_s=0.5,
                                      decay_times=DECAY_TIMES)
    rooms = JaxThreeRoomDataset(path, nfft=NFFT), ThreeRoomDataset(path, nfft=NFFT)
    cdt = np.stack([np.array(DECAY_TIMES)] * len(BANDS)) * np.linspace(1.2, 0.8, len(BANDS))[:, None]
    for room in rooms:
        room.common_decay_times, room.band_centre_hz = cdt, BANDS
    return rooms


def _same_batches(ours, ref) -> None:
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for got, want in zip(ours, ref):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("shuffle,drop_last,pad,n,seed", [
    (True, True, False, 19, 0), (False, True, False, 19, None), (True, False, False, 19, 3),
    (True, False, True, 19, 4), (False, False, True, 5, None), (True, False, True, 3, 1),
])
def test_iterate_batches_equal_jax(grid, shuffle, drop_last, pad, n, seed):
    jroom, room = grid
    idx = np.random.RandomState(7).permutation(24)[:n]
    _same_batches(
        iterate_batches(arrays_from_room_dataset(room), idx, BATCH, shuffle=shuffle,
                        drop_last=drop_last, seed=seed, pad_to_batch=pad),
        jax_iterate_batches(jax_arrays(jroom), idx, BATCH, shuffle=shuffle,
                            drop_last=drop_last, seed=seed, pad_to_batch=pad))


@pytest.mark.parametrize("items,batch", [(19, 8), (16, 8), (3, 8), (0, 4), (33, 32)])
def test_num_batches_equal_jax(items, batch):
    for drop_last in (True, False):
        assert num_batches(items, batch, drop_last) == jax_num_batches(items, batch, drop_last)


def _fit_both(tmp_path, grid, svf: bool, features: bool, **trainer) -> dict:
    """JAX's and the port's ``fit`` from one start on the grid's batches."""
    jroom, room = grid
    raw = raw_config(tmp_path, svf, nfft=NFFT, batch=BATCH)
    raw["trainer_config"].update(max_epochs=2, use_edc_mask=False)
    patience, tol = trainer.pop("patience", None), trainer.pop("early_stop_tol", None)
    raw["trainer_config"].update(trainer)
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["jax"])))
    jmodel, params = jax_model_and_params(jcfg, jroom, BATCH)
    params = jax.tree_util.tree_map(np.asarray, params)
    jarr = jax_arrays(jroom)
    train_idx, valid_idx = train_valid_split(np.arange(jarr.num_items), 0.8, seed=jcfg.seed)
    steps = num_batches(len(train_idx), BATCH)
    jtrainer = JaxGFDNTrainer(jmodel, jcfg.trainer_config, steps,
                              common_decay_times=jroom.common_decay_times, sample_rate=FS)

    cfg = DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["port"])))
    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device="cpu")
    load_jax_params(model, params)
    ours = GFDNTrainer(model, cfg.trainer_config, steps, common_decay_times=room.common_decay_times,
                       sample_rate=FS, device="cpu")
    parr = arrays_from_room_dataset(room)
    for t in (jtrainer, ours):
        if patience is not None:
            t.patience, t.early_stop_tol = patience, tol
    if features:
        jtrainer.precompute_target_features(jarr)
        ours.precompute_target_features(parr)
    ref = jtrainer.fit(jax.tree_util.tree_map(jnp.asarray, params),
                       lambda e: jax_iterate_batches(jarr, train_idx, BATCH, seed=e),
                       lambda: jax_iterate_batches(jarr, valid_idx, BATCH, shuffle=False,
                                                   drop_last=False), seed=jcfg.seed)
    ours.fit(lambda e: iterate_batches(parr, train_idx, BATCH, seed=e),
             lambda: iterate_batches(parr, valid_idx, BATCH, shuffle=False, drop_last=False),
             seed=cfg.seed)
    return {"jax": jtrainer, "port": ours, "ref_params": ref, "dirs": dirs}


def _rel(got: float, ref: float) -> float:
    """|got - ref| / |ref|; |got| where the term is 0 (a zero weight)."""
    return abs(got - ref) / abs(ref) if ref else abs(got)


def check_fit(runs, record_property, epochs: int) -> None:
    jt, pt = runs["jax"], runs["port"]
    assert len(jt.train_loss) == len(pt.train_loss) == len(jt.valid_loss) == len(pt.valid_loss) \
        == epochs
    for epoch in range(epochs):
        worst = 0.0
        for split in ("train", "valid"):
            ref, got = getattr(jt, f"{split}_loss")[epoch], getattr(pt, f"{split}_loss")[epoch]
            worst = max(worst, _rel(got, ref))
            ref = getattr(jt, f"individual_{split}_loss")[epoch]
            got = getattr(pt, f"individual_{split}_loss")[epoch]
            assert sorted(got) == sorted(ref)
            for k, v in ref.items():
                worst = max(worst, _rel(got[k], v))
        record_property(f"worst_loss_rel_e{epoch}", worst)
        assert worst <= LOSS_TOL[epoch], (epoch, worst)
    flat_ref = jax.tree_util.tree_leaves_with_path(runs["ref_params"])
    got = dict(jax.tree_util.tree_leaves_with_path(jax_params_from_torch(pt.model)))
    assert len(got) == len(flat_ref)
    errs = {jax.tree_util.keystr(p): rel_l2(got[p], np.asarray(leaf)) for p, leaf in flat_ref}
    record_property("worst_param_rel_l2", max(errs.values()))
    for path, err in errs.items():
        assert err <= PARAM_TOL, (path, err)
    listings = [sorted(os.listdir(os.path.join(runs["dirs"][side], "checkpoints")))
                for side in ("jax", "port")]
    assert listings[0] == listings[1] == sorted(f"model_e{e}.ckpt" for e in range(-1, epochs))


def test_fit_scalar_heads_on_spectra_stops_as_jax(tmp_path, grid, record_property):
    """Scalar heads, raw target spectra; early stopping forced after the
    second of three epochs in both packages."""
    runs = _fit_both(tmp_path, grid, False, False, max_epochs=3, patience=1, early_stop_tol=1e9)
    check_fit(runs, record_property, 2)
    assert runs["jax"]._early_stop == runs["port"]._early_stop == 1


def test_fit_svf_heads_on_features(tmp_path, grid, record_property):
    check_fit(_fit_both(tmp_path, grid, True, True), record_property, 2)


@pytest.mark.slow
@pytest.mark.parametrize("svf,features", [(True, False), (False, True)],
                         ids=["svf_spectra", "scalar_features"])
def test_fit_other_heads_and_branches(tmp_path, grid, svf, features, record_property):
    check_fit(_fit_both(tmp_path, grid, svf, features), record_property, 2)


@pytest.mark.parametrize("svf", [False, True], ids=["scalar", "svf"])
def test_fit_steps_as_fit_indexed_on_the_same_batches(tmp_path, grid, svf):
    """The port's ``fit`` on host batches that hold ``fit_indexed``'s batches
    (its permutations, the tail padded from the head, the EDC mask on)
    trains bit for bit as ``fit_indexed`` given the same early spectra (the
    host's rfft), in three epochs."""
    _, room = grid
    runs = {}
    for kind in ("indexed", "host"):
        raw = raw_config(tmp_path / kind, svf, nfft=NFFT, batch=BATCH)
        raw["trainer_config"].update(max_epochs=3, use_edc_mask=True)
        cfg = DiffGFDNConfig.from_dict(raw)
        model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz, device="cpu")
        arrays = arrays_from_room_dataset(room)
        train_idx, valid_idx = train_valid_split(np.arange(24), 0.8, seed=cfg.seed)
        trainer = GFDNTrainer(model, cfg.trainer_config, 3, device="cpu",
                              common_decay_times=room.common_decay_times, sample_rate=FS)
        trainer.precompute_target_features(arrays)
        if kind == "indexed":
            trainer.upload_arrays(arrays)
            trainer.data["target_early_response"] = torch.from_numpy(arrays.target_early_response)
            trainer.fit_indexed(arrays, train_idx, valid_idx, seed=cfg.seed)
        else:
            rng = np.random.RandomState(cfg.seed)
            perms = [train_idx[rng.permutation(len(train_idx))] for _ in range(3)]
            trainer.fit(lambda e: iterate_batches(arrays, perms[e], BATCH, shuffle=False,
                                                  drop_last=False, pad_to_batch=True),
                        lambda: iterate_batches(arrays, valid_idx, BATCH, shuffle=False,
                                                drop_last=False), seed=cfg.seed)
        runs[kind] = trainer
    indexed, host = runs["indexed"], runs["host"]
    assert indexed.train_loss == host.train_loss
    np.testing.assert_allclose(host.valid_loss, indexed.valid_loss, rtol=1e-6)
    for (name, p), q in zip(indexed.model.named_parameters(), host.model.parameters()):
        assert torch.equal(p, q), name


def test_fit_sends_only_what_the_step_reads(tmp_path, grid):
    """A batch with features sends the features, not the three spectra; one
    without them sends the raw target spectrum only; z goes up once."""
    _, room = grid
    cfg = DiffGFDNConfig.from_dict(raw_config(tmp_path, False, nfft=NFFT, batch=BATCH))
    model = build_gfdn_model(cfg, room.common_decay_times, device="cpu")
    trainer = GFDNTrainer(model, cfg.trainer_config, 1, common_decay_times=room.common_decay_times,
                          sample_rate=FS, device="cpu")
    arrays = arrays_from_room_dataset(room)
    batch = next(iterate_batches(arrays, np.arange(24), BATCH, seed=0))
    sent = trainer.send(batch)
    assert "target_rir_response" in sent and "target_late_response" not in sent
    trainer.precompute_target_features(arrays)
    batch = next(iterate_batches(arrays, np.arange(24), BATCH, seed=0))
    again = trainer.send(batch)
    assert {"target_edc_db", "target_edr_db", "target_edr_abs_sum"} <= set(again)
    assert "target_rir_response" not in again
    assert again["z_values"] is sent["z_values"]


def test_fit_runs_one_step_graph_a_batch_shape(tmp_path, grid):
    """A short last batch (``drop_last=False``) has its own step graph, and so
    has the short validation batch; the step inputs are the sent entries and
    the shared ones (z and the mesh), nothing the step does not read."""
    _, room = grid
    raw = raw_config(tmp_path, False, nfft=NFFT, batch=BATCH)
    cfg = DiffGFDNConfig.from_dict(raw)
    model = build_gfdn_model(cfg, room.common_decay_times, device="cpu")
    trainer = GFDNTrainer(model, cfg.trainer_config, 3, device="cpu",
                          common_decay_times=room.common_decay_times, sample_rate=FS)
    arrays = arrays_from_room_dataset(room)
    trainer.fit(lambda e: iterate_batches(arrays, np.arange(19), BATCH, drop_last=False, seed=e),
                lambda: iterate_batches(arrays, np.arange(19, 24), BATCH, drop_last=False))
    shapes = sorted((g.inputs["listener_position"].shape[0], len(g.inputs)) for g in trainer.graphs)
    inputs = {"z_values", "mesh_2d", "source_position", "listener_position",
              "norm_listener_position", "target_early_response", "target_rir_response"}
    assert shapes == [(3, len(inputs)), (5, len(inputs)), (8, len(inputs))]
    assert all(set(g.inputs) == inputs for g in trainer.graphs)


def test_directional_trainer_inherits_fit(tmp_path, record_property):
    """One epoch of the directional trainer's inherited ``fit`` at ambi
    order 1 (12 lines in 3 groups, 44 receivers: 35 train, 9 valid), at
    |z| = 1.001 (the arrays' sampling radius): on the unit circle the
    per-step io-gain normalization of the lossless 4-line sub-FDNs is
    rounding-bound, as in ROADMAP C14, and the io gains after the epoch
    part by 3-4 % while every other leaf agrees within 5e-3."""
    jroom, room = spatial_rooms(tmp_path, decay_times=(0.2, 0.3, 0.25))
    raw = directional_raw_config(tmp_path, 1, batch=BATCH, use_edc_mask=False,
                                 spectral_loss_weight=0.0)
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["jax"])))
    jmodel, params = jax_directional_model_and_params(jcfg, jroom, BATCH)
    params = jax.tree_util.tree_map(np.asarray, params)
    cdt = np.asarray(jroom.common_decay_times)
    times = cdt.reshape(-1)[: jcfg.num_groups]
    length = ms_to_samps(float(np.max(cdt)) * 1e3, FS)
    jarr = jax_spatial_arrays(jroom, new_sampling_radius=RADIUS)
    parr = arrays_from_spatial_dataset(room, new_sampling_radius=RADIUS)
    train_idx, valid_idx = train_valid_split(np.arange(jarr.num_items), 0.8, seed=jcfg.seed)
    steps = num_batches(len(train_idx), BATCH)
    jtrainer = JaxDirectionalGFDNTrainer(
        jmodel, jcfg.trainer_config, steps, common_decay_times=jroom.common_decay_times,
        sample_rate=FS,
        directional_envelopes=np.asarray(jax_make_decay_envelopes(times, length, FS)))
    cfg = DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=dirs["port"])))
    model = build_gfdn_model(cfg, room.common_decay_times, room.band_centre_hz,
                             variant="directional", device="cpu",
                             desired_directions=room.desired_directions)
    load_jax_params(model, params)
    ours = DirectionalGFDNTrainer(
        model, cfg.trainer_config, steps, common_decay_times=room.common_decay_times,
        sample_rate=FS, device="cpu",
        directional_envelopes=make_decay_envelopes(times, length, FS))
    ref = jtrainer.fit(jax.tree_util.tree_map(jnp.asarray, params),
                       lambda e: jax_iterate_batches(jarr, train_idx, BATCH, seed=e),
                       lambda: jax_iterate_batches(jarr, valid_idx, BATCH, shuffle=False,
                                                   drop_last=False), seed=jcfg.seed)
    ours.fit(lambda e: iterate_batches(parr, train_idx, BATCH, seed=e),
             lambda: iterate_batches(parr, valid_idx, BATCH, shuffle=False, drop_last=False),
             seed=cfg.seed)
    check_fit({"jax": jtrainer, "port": ours, "ref_params": ref, "dirs": dirs},
              record_property, 1)
