"""The floor-plan CNN of the common-slopes models against the JAX package on
the CPU, on JAX's own spatial fixture (a 0.6 m grid at 8 kHz, 0.2 s SRIRs,
decays 0.05-0.09 s) with an 8-channel, 3-layer CNN and 4 Fourier features.

* the grid data: floor mask, mesh, labels and square patches equal JAX's
  array for array;
* ``ConvNet`` (a (3, 5) kernel, unequal channels, a non-square grid) and
  ``DirectionalBeamformerWeightsCNN`` on carried weights: 1e-5 relative L2;
  a JAX tree through the port and back: exact;
* one CNN step (the floor mask in the loss): loss 1e-5 relative, gradients
  1e-4 relative L2 against JAX's ``_losses``;
* ``run_training_spatial_sampling`` for 4 epochs at one resolution from
  JAX's initialization: each epoch's loss within 1e-3 relative at epoch 1
  and 1e-2 at epoch 4;
* ``fit`` with ``scan_epochs`` True and False: bit for bit;
* ``get_output_from_trained_model`` on a checkpoint written by JAX: 1e-5;
  ``get_ambisonic_rirs`` serves SRIRs from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config import spatial_preset_config
from diffgfdn_torch.data import create_2d_grid_data, square_patch_indices
from diffgfdn_torch.inference import get_ambisonic_rirs, get_output_from_trained_model
from diffgfdn_torch.losses import spatial as port_spatial_losses
from diffgfdn_torch.losses import spatial_edc_loss
from diffgfdn_torch.models.dnn import ConvNet
from diffgfdn_torch.training import (
    build_spatial_model,
    make_cnn_batch,
    run_training_spatial_sampling,
    SpatialSamplingTrainer,
)
from diffgfdn_torch.utils.params import (
    jax_grads_from_torch,
    jax_params_from_torch,
    load_jax_params,
    torch_state_from_jax,
)
from diffgfdn_tpu.data.spatial_dataset import create_2d_grid_data as jax_grid_data
from diffgfdn_tpu.data.spatial_dataset import square_patch_indices as jax_patches
from diffgfdn_tpu.models.dnn import ConvNet as JaxConvNet
from diffgfdn_tpu.training.checkpoints import save_checkpoint as jax_save_checkpoint
from diffgfdn_tpu.training.spatial_trainer import build_spatial_model as jax_build
from diffgfdn_tpu.training.spatial_trainer import make_cnn_batch as jax_cnn_batch
from diffgfdn_tpu.training.spatial_trainer import (
    run_training_spatial_sampling as jax_run,
    SpatialSamplingTrainer as JaxSpatialSamplingTrainer,
)
from diffgfdn_tpu.inference.spatial_inference import (
    get_output_from_trained_model as jax_output,
)
from torch_port_helpers import cs_configs, cs_raw_config, cs_room_path, cs_rooms, rel_l2

FORWARD_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
EPOCHS = 4
FIRST_TOL, LAST_TOL = 1e-3, 1e-2
AMP_TOL = 1e-5
RESOLUTION_M = 1.2


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    return cs_rooms(cs_room_path(tmp_path_factory.mktemp("cs_cnn")))


def cnn_raw(train_dir, epochs: int = EPOCHS, kernel=(3, 3)) -> dict:
    """JAX's CNN test config (``tests/test_spatial_training.py``)."""
    raw = cs_raw_config(train_dir, True, epochs)
    raw["dnn_config"] = dict(
        cnn_config=dict(num_hidden_channels=8, num_layers=3, kernel_size=list(kernel)),
        num_fourier_features=4)
    return raw


def cnn_models(jcfg, cfg, jax_room, batch):
    """(JAX model, its params from PRNGKey(seed) as JAX's sweep draws them,
    the port model on the CPU with those params loaded)."""
    jmodel = jax_build(jcfg, jax_room.num_rooms, jax_room.ambi_order)
    params = jmodel.init(jax.random.PRNGKey(jcfg.seed), batch)
    model = build_spatial_model(cfg, jax_room.num_rooms, jax_room.ambi_order, device="cpu")
    load_jax_params(model, params)
    return jmodel, params, model


@pytest.mark.parametrize("resolution", [0.6, 1.2, 1.8])
def test_grid_batch_equals_jax(rooms, resolution):
    """Mask, mesh (raw and normalized) and labels of the CNN batch."""
    from diffgfdn_torch.data import split_by_grid_resolution

    jax_room, room = rooms
    idx, _ = split_by_grid_resolution(room, resolution)
    got, ref = make_cnn_batch(room, idx), jax_cnn_batch(jax_room, idx)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for a, b in zip(create_2d_grid_data(room, idx), jax_grid_data(jax_room, idx)):
        np.testing.assert_array_equal(a, b)
    mesh = got["mesh_2d_raw"]
    np.testing.assert_array_equal(room.get_binary_mask(mesh), jax_room.get_binary_mask(mesh))
    # the floor plan has holes on this grid: masked cells have zero labels
    mask = got["floor_mask"].astype(bool)
    assert 0 < mask.sum() < mask.size
    assert not got["target_common_slope_amps"][~mask].any()


def _holed_grid() -> np.ndarray:
    """A 7 x 5 grid at 0.3 m with three receivers missing."""
    xm, ym = np.meshgrid(1.0 + 0.3 * np.arange(7), 2.0 + 0.3 * np.arange(5))
    xy = np.stack([xm.ravel(), ym.ravel(), np.full(xm.size, 1.5)], axis=-1)
    return np.delete(xy, [3, 11, 20], axis=0), 0.3


@pytest.mark.parametrize("patch,step,drop,shuffle", [
    (2, 1, False, False), (3, 2, False, False), (2, 1, True, False), (4, 3, False, True),
    (1, 1, True, True),
])
@pytest.mark.parametrize("coords", ["dataset", "holed_grid"])
def test_square_patches_equal_jax(rooms, coords, patch, step, drop, shuffle):
    _, room = rooms
    xy, spacing = ((room.receiver_position, room.grid_spacing_m) if coords == "dataset"
                   else _holed_grid())
    kw = dict(step_size=step, drop_incomplete=drop, shuffle=shuffle, seed=5)
    got = square_patch_indices(xy, patch, spacing, **kw)
    ref = jax_patches(xy, patch, spacing, **kw)
    assert len(got) == len(ref)
    assert len(got) > 0 or (drop and coords == "dataset")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_convnet_forward_matches_jax_on_a_non_square_kernel(record_property):
    """A (3, 5) kernel, 6 input, 8 hidden and 2 x 9 output channels on a 7 x
    11 grid: a kernel carried with the wrong axes would not pass."""
    jnet = JaxConvNet(out_channels=9, num_groups=2, hidden_channels=8, num_layers=3,
                      kernel_size=(3, 5))
    x = np.random.RandomState(0).randn(7, 11, 6).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(1), x)
    ref = np.asarray(jnet.apply(params, x))
    net = ConvNet(6, 9, 2, 8, 3, (3, 5))
    # a bare ConvNet's tree has no ConvNet_0 level: Conv_i maps to conv.i
    net.load_state_dict(torch_state_from_jax(params), strict=True)
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (7, 11, 2, 9)
    err = rel_l2(got, ref)
    record_property("rel_l2", err)
    assert err <= FORWARD_TOL


def test_cnn_head_forward_matches_jax_and_trees_round_trip(rooms, tmp_path, record_property):
    jax_room, room = rooms
    jcfg, cfg = cs_configs(cnn_raw(tmp_path, kernel=(3, 5)))
    batch = jax_cnn_batch(jax_room)
    jmodel, params, model = cnn_models(jcfg, cfg, jax_room, batch)
    ref = np.asarray(jmodel.apply(params, batch))
    got = model({"mesh_2d": torch.from_numpy(batch["mesh_2d"])}).detach().numpy()
    h, w = batch["mesh_2d"].shape[:2]
    assert h != w and got.shape == ref.shape == (h * w, 3, 9)
    err = rel_l2(got, ref)
    record_property("rel_l2", err)
    assert err <= FORWARD_TOL
    # JAX tree -> port -> JAX tree, exact, and the port's init has JAX's tree
    back = jax_params_from_torch(model)
    flat_ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, params))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_back, flat_ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    fresh = jax_params_from_torch(build_spatial_model(cfg, 3, 2, device="cpu"))
    assert jax.tree_util.tree_map(np.shape, fresh) == jax.tree_util.tree_map(np.shape, back)


def test_port_initialization_is_flax_lecun_normal(tmp_path):
    """Each conv weight: a normal truncated at 2 std with variance 1 / fan_in
    (as flax's ``lecun_normal``), zero bias; the sample std of the 32-channel
    preset's widest layer within 5 %."""
    cfg = spatial_preset_config("spatial_directional_1000Hz_cnn")
    model = build_spatial_model(cfg, 3, 2, device="cpu")
    convs = list(model.cnn.conv)
    assert len(convs) == 4 and [c.out_channels for c in convs] == [32, 32, 32, 27]
    for conv in convs:
        fan_in = conv.in_channels * 9
        w = conv.weight.detach().numpy()
        std = np.sqrt(1.0 / fan_in)
        assert not conv.bias.detach().numpy().any()
        assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
        assert abs(w.std() / std - 1.0) < 0.05


def test_cnn_step_matches_jax(rooms, tmp_path, record_property):
    jax_room, room = rooms
    jcfg, cfg = cs_configs(cnn_raw(tmp_path))
    from diffgfdn_torch.data import split_by_grid_resolution

    idx, _ = split_by_grid_resolution(room, RESOLUTION_M)
    batch = jax_cnn_batch(jax_room, idx)
    jmodel, params, model = cnn_models(jcfg, cfg, jax_room, batch)
    jtrainer = JaxSpatialSamplingTrainer(jmodel, jcfg, jax_room)
    (ref, _), grads = jax.value_and_grad(jtrainer._loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    trainer = SpatialSamplingTrainer(model, cfg, room, device="cpu")
    loss = trainer.loss_and_grads(trainer.to_device(make_cnn_batch(room, idx)))
    loss_rel = abs(loss.item() - float(ref)) / abs(float(ref))
    errs = [rel_l2(g, np.asarray(r)) for g, r in zip(
        jax.tree_util.tree_leaves(jax_grads_from_torch(model)),
        jax.tree_util.tree_leaves(grads))]
    record_property("loss_rel", loss_rel)
    record_property("worst_grad_rel_l2", max(errs))
    assert loss_rel <= LOSS_TOL
    assert max(errs) <= GRAD_TOL


def test_chunked_edc_loss_equals_one_chunk(rooms, tmp_path, monkeypatch):
    """The directional EDC loss in chunks of 3 receivers against one chunk:
    the same loss and gradient to rounding (a chunk's partial sums)."""
    _, room = rooms
    cfg = cs_configs(cnn_raw(tmp_path))[1]
    trainer = SpatialSamplingTrainer(build_spatial_model(cfg, 3, 2, device="cpu"), cfg, room,
                                     device="cpu")
    batch = trainer.to_device(make_cnn_batch(room))
    per_row = 12 * trainer.envelopes.shape[-1]
    out = []
    for rows in (len(batch["target_common_slope_amps"]), 3):
        monkeypatch.setattr(port_spatial_losses, "CHUNK_ELEMENTS", rows * per_row)
        amps = trainer._predict(batch)[0].detach().requires_grad_(True)
        loss = spatial_edc_loss(amps, batch["target_common_slope_amps"], trainer.envelopes)
        loss.backward()
        out.append((loss.item(), amps.grad))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[0][0])
    assert rel_l2(out[1][1].numpy(), out[0][1].numpy()) <= 1e-6


def test_directional_edc_loss_matches_autograd_of_db(rooms, tmp_path, record_property):
    """The directional EDC loss's hand-written derivative against autograd
    through ``db`` (the loss as JAX writes it), in chunks of 3 receivers, on
    the CNN's grid with its floor mask: cells whose prediction equals the
    target (outside the floor) and zero amplitudes take a zero gradient, and
    the loss and gradient agree within 1e-6."""
    from diffgfdn_torch.ops.basic import db

    _, room = rooms
    cfg = cs_configs(cnn_raw(tmp_path))[1]
    trainer = SpatialSamplingTrainer(build_spatial_model(cfg, 3, 2, device="cpu"), cfg, room,
                                     device="cpu")
    batch = trainer.to_device(make_cnn_batch(room))
    target = batch["target_common_slope_amps"].clone()
    target[0, 0] = 0.0
    mask = batch["floor_mask"][:, None, None]
    assert 0 < float(mask.sum()) < len(mask)
    env = trainer.envelopes
    amps = trainer._predict(batch)[0].detach().requires_grad_(True)
    pred = amps * mask + (1.0 - mask) * target

    def autograd_loss(x):
        return torch.mean(torch.abs(db(torch.einsum("bjk,kt->bjt", target, env), is_squared=True)
                                    - db(torch.einsum("bjk,kt->bjt", x, env), is_squared=True)))

    ref = autograd_loss(pred)
    (ref_grad,) = torch.autograd.grad(ref, amps, retain_graph=True)
    old = port_spatial_losses.CHUNK_ELEMENTS
    port_spatial_losses.CHUNK_ELEMENTS = 3 * 12 * env.shape[-1]
    try:
        loss = spatial_edc_loss(pred, target, env)
        (grad,) = torch.autograd.grad(loss, amps)
    finally:
        port_spatial_losses.CHUNK_ELEMENTS = old
    outside = batch["floor_mask"] == 0
    assert bool(torch.all(grad[outside] == 0)) and bool(torch.all(ref_grad[outside] == 0))
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    grad_rel = rel_l2(grad.numpy(), ref_grad.numpy())
    record_property("loss_rel", loss_rel)
    record_property("grad_rel_l2", grad_rel)
    assert loss_rel <= 1e-6 and grad_rel <= 1e-6


def test_cnn_sweep_matches_jax(rooms, tmp_path, monkeypatch, record_property):
    """``run_training_spatial_sampling`` on the CNN config, 4 epochs at one
    resolution, from JAX's initialization (the port's `build_spatial_model` patched to load
    it): each epoch's loss against JAX's run."""
    jax_room, room = rooms
    jcfg, cfg = cs_configs(cnn_raw(tmp_path / "port"))
    jcfg.train_dir = str(tmp_path / "jax")
    batch = jax_cnn_batch(jax_room)
    _, params, _ = cnn_models(jcfg, cfg, jax_room, batch)
    real_build = build_spatial_model

    def from_jax(*args, **kwargs):
        return load_jax_params(real_build(*args, **kwargs), params)

    monkeypatch.setattr("diffgfdn_torch.training.spatial_trainer.build_spatial_model", from_jax)
    ref = jax_run(jcfg, jax_room, grid_resolutions=[RESOLUTION_M])[RESOLUTION_M][0].train_loss
    trainer, _ = run_training_spatial_sampling(cfg, room, grid_resolutions=[RESOLUTION_M],
                                               device="cpu")[RESOLUTION_M]
    got = trainer.train_loss
    assert len(got) == len(ref) == EPOCHS
    errs = [abs(p - r) / abs(r) for p, r in zip(got, ref)]
    record_property("train_loss_rel_per_epoch", errs)
    assert errs[0] <= FIRST_TOL and max(errs) <= LAST_TOL, errs
    assert got[-1] < got[0]
    ckpt = tmp_path / "port" / f"grid_resolution={RESOLUTION_M:.1f}" / "checkpoints"
    assert sorted(p.name for p in ckpt.glob("model_e*.ckpt")) == [
        f"model_e{e}.ckpt" for e in range(EPOCHS)]


def test_fit_graphed_and_eager_are_bit_for_bit(rooms, tmp_path):
    """``fit`` with ``scan_epochs`` True (the step graph's static buffers) and
    False (eager), from one initialization, a static batch and a validation
    batch: every epoch's losses and the parameters equal."""
    _, room = rooms
    cfg = cs_configs(cnn_raw(tmp_path, epochs=3))[1]
    batch = make_cnn_batch(room)
    runs = []
    for scan in (True, False):
        model = build_spatial_model(cfg, 3, 2, device="cpu")
        trainer = SpatialSamplingTrainer(model, cfg, room, device="cpu")
        trainer.scan_epochs = scan
        trainer.fit(lambda epoch: iter([batch]), valid_batches=lambda: iter([batch]),
                    static_batches=True)
        runs.append((trainer.train_loss, trainer.valid_loss,
                     {k: v.clone() for k, v in model.state_dict().items()},
                     len(list(trainer.graphs))))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert len(runs[0][0]) == 3 and runs[0][0][-1] < runs[0][0][0]
    for k in runs[0][2]:
        assert torch.equal(runs[0][2][k], runs[1][2][k]), k
    assert runs[0][3] == 2 and runs[1][3] == 0  # the train and the valid graph


def test_cnn_serves_a_jax_checkpoint(rooms, tmp_path, record_property):
    jax_room, room = rooms
    jcfg, cfg = cs_configs(cnn_raw(tmp_path))
    batch = jax_cnn_batch(jax_room)
    jmodel = jax_build(jcfg, 3, 2)
    params = jmodel.init(jax.random.PRNGKey(7), batch)
    jax_save_checkpoint(str(tmp_path / f"grid_resolution={RESOLUTION_M:.1f}"),
                        EPOCHS - 1, params)
    query = room.receiver_position[::9] + np.array([0.05, -0.04, 0.0])
    ref = np.asarray(jax_output(jcfg, jax_room, query, RESOLUTION_M))
    got = get_output_from_trained_model(cfg, room, query, RESOLUTION_M, device="cpu").numpy()
    assert got.shape == ref.shape == (len(query), 12, 3)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    record_property("max_abs_over_max", err)
    assert err <= AMP_TOL
    # the user entry point serves the CNN's SRIRs from those amplitudes
    out = get_ambisonic_rirs(query, room, use_trained_model=True, configs=[cfg],
                             grid_resolution_m=RESOLUTION_M, device="cpu")
    assert out.rirs.shape == (len(query), 9, room.rir_length)
    assert np.isfinite(out.rirs).all() and np.abs(out.rirs).max() > 0


def test_cnn_trainer_keeps_convolutions_at_full_f32(rooms, tmp_path):
    """Building the CNN's trainer turns cuDNN's TF32 off (JAX pins full f32)
    and leaves ``cudnn.benchmark`` off, even after a caller turned TF32 on."""
    _, room = rooms
    cfg = cs_configs(cnn_raw(tmp_path))[1]
    torch.backends.cudnn.allow_tf32 = True
    SpatialSamplingTrainer(build_spatial_model(cfg, 3, 2, device="cpu"), cfg, room,
                           device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.benchmark
