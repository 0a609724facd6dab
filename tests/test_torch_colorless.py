"""The colorless prototype FDN and its warm start in the port against the JAX package.

At fs 8 kHz on the CPU, from the same (JAX-initialized) parameters:

* ``ColorlessFDN`` (RANDOM coupling: one dense orthogonal matrix, its (F, N,
  N) inverse through the Gauss-Jordan autograd function): H and the
  per-line H on the trainer's bins within 1e-4 relative L2 at |z| = 1.001,
  and within the slice bound 1e-3 on the circle, where the packages'
  rounding of z^m (ROADMAP C7) is amplified by the nearly lossless loop's
  resonances (C14); the trainer loss's gradients within 2e-3 (C3), at
  N = 4 and 8;
* a 2-epoch ``ColorlessFDNTrainer.fit``: train and valid losses of every
  epoch within 1e-3 relative of JAX's;
* ``skew_preimage`` / ``colorless_to_init``: exp(skew(.)) of the pre-images
  gives the prototypes' matrices back within 1e-4, and equals JAX's;
* a pickle JAX writes loads in a process that never imports JAX or the JAX
  package; the port's own pickles name the port's class;
* the grid solver warm-started from prototypes (the
  ``synth_broadband_colorless_proto`` preset, narrowed): the io gains are
  buffers, not parameters, the per-group caches exist, the feedback blocks
  start at the prototypes' matrices, the losses are finite; JAX's
  ``InferDiffGFDN`` (its ``make_rir_synthesis_fn``) serves the port's
  checkpoint and prototypes as the port's ``InferDiffGFDN`` does (1e-3
  relative L2), and a missing prototype is retrained with a warning;
* a 3-epoch single-position prototype run (the single-room preset's heads)
  from JAX's prototype and initial checkpoint: the train loss of every
  epoch within 1e-3 relative of JAX's.
"""

import copy
from pathlib import Path
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.config import PRESETS
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.inference import InferDiffGFDN
from diffgfdn_torch.ops.unitary import orthogonal_from_skew
from diffgfdn_torch.training import (
    build_colorless_fdn,
    colorless_to_init,
    ColorlessFDNResults,
    ColorlessFDNTrainer,
    load_checkpoint,
    load_colorless_result,
    param_labels,
    run_training_single_pos,
    run_training_var_receiver_pos,
    skew_preimage,
)
from diffgfdn_torch.training import solver as port_solver
from diffgfdn_torch.utils.params import jax_grads_from_torch, load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data import ThreeRoomDataset as JaxThreeRoomDataset
from diffgfdn_tpu.inference import InferDiffGFDN as JaxInferDiffGFDN
from diffgfdn_tpu.losses import mse_loss as jax_mse, sparsity_loss as jax_sparsity
from diffgfdn_tpu.ops.unitary import orthogonal_from_skew as jax_orthogonal_from_skew
from diffgfdn_tpu.training import build as jax_build
from diffgfdn_tpu.training.checkpoints import load_checkpoint as jax_load_checkpoint
from diffgfdn_tpu.training.colorless_trainer import ColorlessFDNTrainer as JaxColorlessTrainer
from diffgfdn_tpu.training.save_results import (
    save_colorless_fdn_parameters as jax_save_colorless,
)
from diffgfdn_tpu.training.solver import run_training_single_pos as jax_run_training_single_pos
from torch_port_helpers import FS, rel_l2, single_pos_raw, write_two_slope_wav

ROOT = Path(__file__).resolve().parents[1]
H_TOL = 1e-4
H_TOL_ON_CIRCLE = 1e-3
OFF_CIRCLE = 1.001
GRAD_TOL = 2e-3
LOSS_TOL = 1e-3
MATRIX_TOL = 1e-4
RIR_TOL = 1e-3
NUM_BINS = 512  # the prototype's bins: nfft 2^13 / 16


def _raw(tmp_path, groups: int, lines: int, epochs: int = 2) -> dict:
    return dict(seed=13, num_groups=groups, sample_rate=FS, num_delay_lines=lines,
                delay_range_ms=[20.0, 45.0],
                trainer_config=dict(train_dir=str(tmp_path / "train")),
                colorless_fdn_config=dict(use_colorless_prototype=True, max_epochs=epochs,
                                          batch_size=300, lr=0.02))


@pytest.fixture(scope="module")
def prototypes(tmp_path_factory):
    """``prototypes(groups, lines)`` -> (raw config, JAX trainer of the last
    group's prototype, its initial params, a fresh port ColorlessFDN with
    them); the JAX side is built once per module for each shape."""
    cache = {}

    def get(groups: int, lines: int):
        if (groups, lines) not in cache:
            raw = _raw(tmp_path_factory.mktemp("colorless"), groups, lines)
            jcfg = JaxDiffGFDNConfig.model_validate(raw)
            jmodel = jax_build.build_colorless_fdn(jcfg, groups - 1)
            jtrainer = JaxColorlessTrainer(jmodel, jcfg.colorless_fdn_config, "unused")
            cache[groups, lines] = raw, jtrainer, jtrainer.init_params(seed=jcfg.seed + groups - 1)
        raw, jtrainer, params = cache[groups, lines]
        model = build_colorless_fdn(DiffGFDNConfig.from_dict(raw), groups - 1, device="cpu")
        return raw, jtrainer, params, load_jax_params(model, params)

    return get


@pytest.mark.parametrize("groups,lines", [(2, 8), (1, 8)], ids=["n4", "n8"])
def test_colorless_fdn_matches_jax(prototypes, tmp_path, groups, lines, record_property):
    raw, jtrainer, params, model = prototypes(groups, lines)
    assert model.num_delay_lines == lines // groups
    angles = (np.arange(NUM_BINS) / NUM_BINS * np.pi).astype(np.float32)
    errs = {}
    apply = jax.jit(jtrainer.model.apply)
    for radius, bound in ((OFF_CIRCLE, H_TOL), (1.0, H_TOL_ON_CIRCLE)):
        z = (radius * np.exp(1j * angles)).astype(np.complex64)
        h_ref, per_ref = apply(params, jnp.asarray(z))
        with torch.no_grad():
            h, per = model(torch.from_numpy(z))
        errs[radius] = (rel_l2(h.numpy(), np.asarray(h_ref)),
                        rel_l2(per.numpy(), np.asarray(per_ref)))
        assert max(errs[radius]) <= bound, errs
    record_property("rel_l2_off_and_on_circle", errs)

    # the trainer's validation loss (with the per-line term) and its gradients
    def jax_loss(p):
        hh, pp = jtrainer.model.apply(p, jnp.exp(1j * jnp.asarray(angles)).astype(jnp.complex64))
        a = jax_orthogonal_from_skew(p["params"]["feedback_loop"]["random_feedback_matrix"])
        return (jax_mse(hh, jnp.ones(hh.shape)) + jax_mse(pp, jnp.ones(pp.shape))
                + jtrainer.cfg.alpha * jax_sparsity(a))

    ref, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    trainer = ColorlessFDNTrainer(model, DiffGFDNConfig.from_dict(raw).colorless_fdn_config,
                                  str(tmp_path / "c"), device="cpu")
    loss = trainer.loss(torch.from_numpy(angles), with_per_del=True)
    loss.backward()
    loss_err = abs(float(loss.detach()) - float(ref)) / abs(float(ref))
    got = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(model)))
    grad_errs = {jax.tree_util.keystr(p): rel_l2(got[p], np.asarray(v))
                 for p, v in jax.tree_util.tree_leaves_with_path(grads)}
    assert len(grad_errs) == len(got) == 3
    record_property("loss_rel", loss_err)
    record_property("worst_grad_rel_l2", max(grad_errs.values()))
    assert loss_err <= LOSS_TOL
    assert max(grad_errs.values()) <= GRAD_TOL, grad_errs


def test_colorless_trainer_two_epochs_match_jax(prototypes, tmp_path, record_property):
    raw, jtrainer, params, model = prototypes(2, 8)
    jtrainer.train_dir = str(tmp_path / "jax")
    jtrainer.fit(params, NUM_BINS, seed=14)
    trainer = ColorlessFDNTrainer(model, DiffGFDNConfig.from_dict(raw).colorless_fdn_config,
                                  str(tmp_path / "port"), device="cpu")
    trainer.fit(NUM_BINS, seed=14)
    errs = [abs(a - b) / abs(b) for a, b in zip(trainer.train_loss + trainer.valid_loss,
                                                jtrainer.train_loss + jtrainer.valid_loss)]
    assert len(trainer.train_loss) == len(trainer.valid_loss) == 2
    record_property("epoch_loss_rel", errs)
    assert max(errs) <= LOSS_TOL, (trainer.train_loss, trainer.valid_loss,
                                   jtrainer.train_loss, jtrainer.valid_loss)
    assert set(load_checkpoint(tmp_path / "port", 1)["params"]) == {
        "input_gains", "output_gains", "feedback_loop"}


def test_skew_preimage_and_colorless_to_init_round_trip():
    rng = np.random.RandomState(0)
    results = []
    for _ in range(3):
        q = orthogonal_from_skew(torch.from_numpy(rng.randn(4, 4).astype(np.float32))).numpy()
        results.append(ColorlessFDNResults(rng.randn(4), rng.randn(4), q))
    b, c, m_skew = colorless_to_init(results)
    jb, jc, jm = jax_build.colorless_to_init(results)
    assert b.shape == c.shape == (12, 1) and m_skew.shape == (3, 4, 4)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(m_skew, jm, atol=1e-6)
    np.testing.assert_array_equal(skew_preimage(results[0].opt_feedback_matrix),
                                  jax_build.skew_preimage(results[0].opt_feedback_matrix))
    for g in range(3):
        q2 = orthogonal_from_skew(torch.from_numpy(m_skew[g])).numpy()
        assert np.allclose(q2, results[g].opt_feedback_matrix, atol=MATRIX_TOL)


def test_jax_pickle_loads_without_jax(prototypes, tmp_path):
    _, jtrainer, params, _ = prototypes(2, 8)
    ref = jax_save_colorless(jtrainer.model, params, tmp_path, 0)
    path = tmp_path / "parameters_opt_group=1.pkl"
    assert b"diffgfdn_tpu.training.build" in path.read_bytes()
    code = (
        "import sys\n"
        "from diffgfdn_torch.training.build import ColorlessFDNResults, load_colorless_result\n"
        f"r = load_colorless_result({str(path)!r})\n"
        "assert type(r) is ColorlessFDNResults, type(r)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'diffgfdn_tpu')]\n"
        "assert not bad, bad\n"
        "print(repr(r.opt_feedback_matrix.tolist()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(np.array(eval(out.stdout)), ref.opt_feedback_matrix)
    # a pickle naming anything else of the JAX package is refused
    (tmp_path / "other.pkl").write_bytes(pickle.dumps(jax_build.skew_preimage))
    with pytest.raises(pickle.UnpicklingError):
        load_colorless_result(tmp_path / "other.pkl")


def _grid_raw(tmp_path) -> dict:
    """``synth_broadband_colorless_proto`` narrowed: fs 8 kHz, a 1 x 16 MLP,
    2 epochs, prototypes of 2 epochs."""
    raw = copy.deepcopy(PRESETS["synth_broadband_colorless_proto"])
    raw.update(sample_rate=FS, delay_range_ms=[20.0, 45.0])
    raw["output_filter_config"].update(num_hidden_layers=1, num_neurons_per_layer=16,
                                       num_fourier_features=4)
    raw["trainer_config"].update(max_epochs=2, batch_size=6, num_freq_bins=2 ** 12,
                                 train_dir=str(tmp_path / "train"))
    raw["colorless_fdn_config"]["max_epochs"] = 2
    return raw


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    from diffgfdn_torch.data import ThreeRoomDataset
    from diffgfdn_tpu.data import generate_three_room_pickle

    tmp = tmp_path_factory.mktemp("colorless_grid")
    path = generate_three_room_pickle(tmp / "srirs.pkl", fs=FS, num_rec_per_room=6,
                                      rir_len_s=0.4, decay_times=(0.3, 0.45, 0.35))
    raw = _grid_raw(tmp)
    cfg = DiffGFDNConfig.from_dict(raw)
    room = ThreeRoomDataset(path, nfft=2 ** 12)
    trainer, model = run_training_var_receiver_pos(cfg, room, device="cpu")
    return tmp, path, raw, room, trainer, model


def test_warm_started_grid_solver(grid_run):
    tmp, _, raw, _, trainer, model = grid_run
    cfg = DiffGFDNConfig.from_dict(raw)
    names = {n for n, _ in model.named_parameters()}
    assert "input_gains" not in names and "output_gains" not in names
    assert model.io_gains_fixed and set(param_labels(model)) == names
    assert "input_gains" not in load_checkpoint(cfg.trainer_config.train_dir, 1)["params"]
    results = [load_colorless_result(tmp / "train" / "colorless-fdn"
                                     / f"parameters_opt_group={g + 1}.pkl") for g in range(2)]
    assert all(type(r) is ColorlessFDNResults for r in results)
    init = load_checkpoint(cfg.trainer_config.train_dir, -1)["params"]["feedback_loop"]["M"]
    blocks = orthogonal_from_skew(torch.from_numpy(init)).numpy()
    for g, r in enumerate(results):
        assert np.abs(blocks[g] - r.opt_feedback_matrix).max() <= MATRIX_TOL
        np.testing.assert_array_equal(model.input_gains[g * 4:(g + 1) * 4, 0].numpy(),
                                      r.opt_input_gains.astype(np.float32))
    assert np.isfinite(trainer.train_loss + trainer.valid_loss).all()


def test_inference_rebuilds_the_warm_start_as_jax_does(grid_run, caplog, record_property):
    tmp, path, raw, room, _, _ = grid_run
    cfg = DiffGFDNConfig.from_dict(raw)
    idx = np.arange(5)
    rirs = InferDiffGFDN(cfg, room, device="cpu").rirs_at(idx, batch_size=4)
    ref = JaxInferDiffGFDN(JaxDiffGFDNConfig.model_validate(raw), JaxThreeRoomDataset(path, nfft=2 ** 12)).rirs_at(
        idx, batch_size=4)
    err = rel_l2(rirs, ref)
    record_property("rir_rel_l2", err)
    assert rirs.shape == ref.shape and err <= RIR_TOL
    # a missing prototype is retrained, with a warning
    proto_dir = tmp / "train" / "colorless-fdn"
    saved = proto_dir / "saved"
    saved.mkdir(exist_ok=True)
    shutil.copy(proto_dir / "parameters_opt_group=2.pkl", saved)
    (proto_dir / "parameters_opt_group=2.pkl").unlink()
    try:
        again = InferDiffGFDN(cfg, room, device="cpu").rirs_at(idx[:2], batch_size=2)
        assert "retraining them now" in caplog.text
        assert (proto_dir / "parameters_opt_group=2.pkl").exists()
        assert np.isfinite(again).all()
    finally:
        shutil.copy(saved / "parameters_opt_group=2.pkl", proto_dir)


def test_single_pos_prototype_run_matches_jax(tmp_path, monkeypatch, record_property):
    """The single-room preset's heads (scalar output, SVF input, N = 8 in
    one group) on |z| = 1: fixed io gains, so no normalization runs."""
    raw = single_pos_raw(tmp_path, False, True, 1, 8)
    raw["colorless_fdn_config"] = dict(use_colorless_prototype=True, max_epochs=2,
                                       batch_size=200)
    write_two_slope_wav(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=str(jdir))))
    jtrainer, _ = jax_run_training_single_pos(jcfg, devices=jax.devices("cpu")[:1])
    shutil.copytree(jdir / "colorless-fdn", pdir / "colorless-fdn")  # JAX's pickles
    init = jax_load_checkpoint(jdir, -1)
    build = port_solver.build_gfdn_model
    monkeypatch.setattr(port_solver, "build_gfdn_model",
                        lambda *a, **kw: load_jax_params(build(*a, **kw), init))
    cfg = DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=str(pdir))))
    trainer, model = run_training_single_pos(cfg, device="cpu")
    assert model.io_gains_fixed
    errs = [abs(a - b) / abs(b) for a, b in zip(trainer.train_loss, jtrainer.train_loss)]
    assert len(errs) == 3
    record_property("epoch_loss_rel", errs)
    assert max(errs) <= LOSS_TOL, (trainer.train_loss, jtrainer.train_loss)
