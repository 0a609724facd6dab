"""Single-position fits in the port against the JAX package on the CPU.

A two-slope synthetic RIR is written as a wav at fs 8 kHz and fit at nfft
2^12 (torch_port_helpers.single_pos_*), as ``run_training_single_pos`` reads
it: a 0.5 s broadband decay time per group. JAX's initial parameters are
carried into the port. Bounds:

* ``read_wav``, ``RIRData`` and ``parse_position_from_filename``: bit for bit;
* ``DiffGFDNSinglePos``'s H (SVF output and scalar input heads at N = 12,
  G = 3; scalar output and SVF input heads at N = 8, G = 2): 1e-3 relative
  L2; with the colorless loss on, the sub-FDN outputs too, evaluated at
  |z| = 1.001 (on the circle the lossless sub-FDNs' poles make them
  rounding-bound, ROADMAP C2);
* gradients of a smooth functional of H, every leaf: 2e-3 relative L2 (C3);
* ``SinglePosGFDNTrainer``'s losses (raw-spectrum EDC and EDR, with and
  without JAX's EDC mask): 1e-3 relative; gradients 1e-2 relative L2; one
  Adam step on identical gradients against optax 1e-6; the io-gain
  normalization and energy match of the io scalars 1e-5 relative L2 (at
  |z| = 1.001: on the circle the normalization is set by the bins next to
  the lossless sub-FDNs' poles, ROADMAP C2 and C14);
* a 3-epoch ``run_training_single_pos`` from JAX's initial checkpoint
  (off the circle, by an alias attenuation): the train loss of every epoch
  within 1e-3 relative of JAX's;
* the CLI fits a config with ``ir_path`` and refuses ``--resume`` for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from scipy.io import loadmat
import torch
import yaml

from diffgfdn_torch.cli.run_model import main as cli_main
from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.data import early_late_split, read_wav, RIRData
from diffgfdn_torch.training import build_gfdn_model, make_optimizer
from diffgfdn_torch.training import parse_position_from_filename
from diffgfdn_torch.training import run_training_single_pos, SinglePosGFDNTrainer
from diffgfdn_torch.training import solver as port_solver
from diffgfdn_torch.utils.params import (
    jax_grads_from_torch,
    jax_params_from_torch,
    load_jax_params,
    torch_state_from_jax,
)
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.data.audio import read_wav as jax_read_wav
from diffgfdn_tpu.data.room_dataset import early_late_split as jax_early_late_split
from diffgfdn_tpu.data.room_dataset import RIRData as JaxRIRData
from diffgfdn_tpu.training import optim as jax_optim
from diffgfdn_tpu.training.checkpoints import load_checkpoint as jax_load_checkpoint
from diffgfdn_tpu.training.solver import parse_position_from_filename as jax_parse_position
from diffgfdn_tpu.training.solver import run_training_single_pos as jax_run_training_single_pos
from diffgfdn_tpu.training.trainer import SinglePosGFDNTrainer as JaxSinglePosGFDNTrainer
from diffgfdn_tpu.utils.cio import encode_batch
from torch_port_helpers import (
    FS,
    rel_l2,
    SINGLE_POS_NFFT,
    single_pos_models,
    single_pos_raw,
    write_two_slope_wav,
)

H_TOL = 1e-3
GRAD_TOL = 2e-3
LOSS_TOL = 1e-3
TRAINER_GRAD_TOL = 1e-2
UPDATE_TOL = 1e-6
NORMALIZE_TOL = 1e-5
OFF_CIRCLE = 1.001
# (output SVF, input SVF, groups, lines): the example's heads, and the
# two-stage presets'
HEADS = {"svf_out": (True, False, 3, 12), "svf_in": (False, True, 2, 8)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """``models(case, **trainer)`` -> (raw config, JAX model, its initial
    params, a fresh port model with them, the numpy batch, the port's
    RIRData); the JAX side is built once per module for each configuration."""
    cache = {}

    def get(heads, **trainer):
        key = (heads, tuple(sorted(trainer.items())))
        if key not in cache:
            tmp = tmp_path_factory.mktemp("single_pos")
            raw = single_pos_raw(tmp, *heads, **trainer)
            _, jmodel, params, _, batch, rir = single_pos_models(raw, tmp)
            cache[key] = (raw, jmodel, params, batch, rir)
        raw, jmodel, params, batch, rir = cache[key]
        model = build_gfdn_model(DiffGFDNConfig.from_dict(raw), rir.common_decay_times,
                                 variant="single_pos", device="cpu")
        return raw, jmodel, params, load_jax_params(model, params), dict(batch), rir

    return get


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _grad_errors(model, ref_grads) -> dict:
    grads = dict(jax.tree_util.tree_leaves_with_path(jax_grads_from_torch(model)))
    flat = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(grads) == len(flat)
    return {jax.tree_util.keystr(p): rel_l2(grads[p], np.asarray(v)) for p, v in flat}


@pytest.mark.parametrize("dtype", [np.float32, np.int16], ids=["float32", "int16"])
def test_read_wav_rirdata_and_position_equal_jax(tmp_path, dtype):
    path = write_two_slope_wav(tmp_path, dtype=dtype)
    data, fs = read_wav(path)
    ref, ref_fs = jax_read_wav(path)
    assert fs == ref_fs == FS and data.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(data, ref)
    for nfft in (SINGLE_POS_NFFT, None):
        kw = dict(common_decay_times=np.array([0.5, 0.3]), nfft=nfft)
        rir, jrir = RIRData.from_wav(path, **kw), JaxRIRData.from_wav(path, **kw)
        assert rir.num_freq_bins == jrir.num_freq_bins
        np.testing.assert_array_equal(rir.freq_bins_rad, jrir.freq_bins_rad)
        np.testing.assert_array_equal(rir.rir_mag_response, jrir.rir_mag_response)
        for got, want in zip(rir.split_responses(), jrir.split_responses()):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(early_late_split(data, 20.0, fs), jax_early_late_split(ref, 20.0, fs)):
        np.testing.assert_array_equal(got, want)
    for name in (str(path), "a/ir_(-1.5, 0.25,3).wav", "rir.wav"):
        got, want = parse_position_from_filename(name), jax_parse_position(name)
        assert (got is None and want is None) or np.array_equal(got, want)


@pytest.mark.parametrize("case", ["svf_out", "svf_in", "svf_in_colorless"])
def test_forward_matches_jax(models, case, record_property):
    colorless = case.endswith("_colorless")
    heads = HEADS[case.removesuffix("_colorless")]
    _, jmodel, params, model, batch, _ = models(
        heads, **({"use_colorless_loss": True} if colorless else {}))
    if colorless:
        batch["z_values"] = (1.001 * batch["z_values"]).astype(np.complex64)
    out = jax.jit(jmodel.apply)(params, batch)
    with torch.no_grad():
        tb = _tensors(batch)
        h = model(tb).numpy()
        sub = model.sub_fdn_output(tb["z_values"])
    direct = batch["target_early_response"]
    errs = {"h": rel_l2(h - direct, np.asarray(out[0] if colorless else out) - direct)}
    if colorless:
        errs["h_sub"] = rel_l2(sub[0].numpy(), np.asarray(out[1][0]))
        errs["h_sub_per_line"] = rel_l2(sub[1].numpy(), np.asarray(out[1][1]))
    assert h.shape == (SINGLE_POS_NFFT // 2 + 1,)
    record_property("rel_l2", errs)
    assert max(errs.values()) <= H_TOL, errs


@pytest.mark.parametrize("case", ["svf_out", "svf_in"])
def test_gradients_match_jax(models, case, record_property):
    _, jmodel, params, model, batch, _ = models(HEADS[case])
    weight = np.random.RandomState(5).uniform(0.5, 1.5, SINGLE_POS_NFFT // 2 + 1)
    weight = weight.astype(np.float32)
    direct = batch["target_early_response"]

    def jax_loss(p):
        h = jmodel.apply(p, batch) - direct
        return jnp.sum(weight * (jnp.real(h) ** 2 + jnp.imag(h) ** 2))

    ref = jax.jit(jax.grad(jax_loss))(params)
    tb = _tensors(batch)
    h = model(tb) - tb["target_early_response"]
    torch.sum(torch.from_numpy(weight) * (h.real ** 2 + h.imag ** 2)).backward()
    errs = _grad_errors(model, ref)
    record_property("worst_grad_rel_l2", max(errs.values()))
    for path, err in errs.items():
        assert err <= GRAD_TOL, (path, err)


def _trainers(models, heads, **trainer):
    """(JAX trainer, initial params, port trainer with its batch uploaded, batch)."""
    raw, jmodel, params, model, batch, rir = models(heads, **trainer)
    cdt = rir.common_decay_times
    jtrainer = JaxSinglePosGFDNTrainer(jmodel, JaxDiffGFDNConfig.model_validate(raw)
                                       .trainer_config, 1, common_decay_times=cdt,
                                       sample_rate=FS)
    trainer = SinglePosGFDNTrainer(model, DiffGFDNConfig.from_dict(raw).trainer_config, 1,
                                   common_decay_times=cdt, sample_rate=FS, device="cpu")
    trainer.upload_batch(batch)
    return jtrainer, params, trainer, batch


@pytest.mark.parametrize("case,mask", [("svf_out", False), ("svf_in", True)],
                         ids=["svf_out", "svf_in_mask"])
def test_trainer_losses_gradients_and_adam_step_match_jax(models, case, mask,
                                                          record_property):
    jtrainer, params, trainer, batch = _trainers(
        models, HEADS[case], **({"use_edc_mask": True} if mask else {}))
    key = jax.random.PRNGKey(11)

    def total(p):
        losses = jtrainer._losses(p, batch, key)
        return sum(losses.values()), losses

    (ref_total, ref_losses), ref_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    mask_values = None
    if mask:  # the mask JAX's edc_loss draws from the step key
        length = trainer.edc_mask_length(SINGLE_POS_NFFT // 2 + 1)
        probs = jax.random.uniform(jax.random.fold_in(key, 0), (length,))
        mask_values = torch.from_numpy(np.asarray(
            jax.random.bernoulli(jax.random.fold_in(key, 1), probs), np.float32))
    tot, losses = trainer.loss_and_grads(trainer.data, mask_values)
    assert sorted(losses) == sorted(ref_losses) == ["edc_loss", "edr_loss"]
    errs = {k: abs(float(losses[k]) - float(v)) / abs(float(v)) for k, v in ref_losses.items()}
    errs["total"] = abs(float(tot) - float(ref_total)) / abs(float(ref_total))
    record_property("loss_rel", errs)
    assert max(errs.values()) <= LOSS_TOL, errs
    grad_errs = _grad_errors(trainer.model, ref_grads)
    record_property("worst_grad_rel_l2", max(grad_errs.values()))
    for path, err in grad_errs.items():
        assert err <= TRAINER_GRAD_TOL, (path, err)

    # one Adam step of each label group on JAX's gradients, both packages
    cfg = trainer.cfg
    opt = jax_optim.make_optimizer(jtrainer.cfg, params, 1)
    updates, _ = opt.update(ref_grads, opt.init(params), params)
    stepped = optax.apply_updates(params, updates)
    optimizer, _ = make_optimizer(cfg, trainer.model, 1)
    grads = torch_state_from_jax(ref_grads)
    for name, p in trainer.model.named_parameters():
        p.grad = grads[name].clone()
    optimizer.step()
    got = torch_state_from_jax(jax_params_from_torch(trainer.model))
    want = torch_state_from_jax(stepped)
    err = max(float(torch.max(torch.abs(got[k] - want[k]))) for k in want)
    record_property("adam_max_abs", err)
    assert err <= UPDATE_TOL


@pytest.mark.parametrize("case", ["svf_out", "scalar_heads"])
def test_normalization_matches_jax(models, case, record_property):
    """The sub-FDN normalization of the io gains and, with scalar heads on
    both sides, the energy match of the io scalars to the target, at
    |z| = 1.001 (on the circle the lossless sub-FDNs' energy is set by the
    few bins next to their poles, ROADMAP C2, C14)."""
    heads = (False, False, 2, 8) if case == "scalar_heads" else HEADS[case]
    jtrainer, params, trainer, batch = _trainers(models, heads)
    batch["z_values"] = (OFF_CIRCLE * batch["z_values"]).astype(np.complex64)
    trainer.upload_batch(batch)
    ref = torch_state_from_jax(jtrainer._normalize(params, encode_batch(batch)))
    trainer._normalize_params()
    got = torch_state_from_jax(jax_params_from_torch(trainer.model))
    before = torch_state_from_jax(params)
    changed = {k for k in ref if not torch.equal(ref[k], before[k])}
    assert changed == ({"input_gains", "output_gains"}
                       | ({"input_scalars", "output_scalars"} if case == "scalar_heads" else set()))
    err = max(rel_l2(got[k].numpy(), ref[k].numpy()) for k in ref)
    record_property("max_rel_l2", err)
    assert err <= NORMALIZE_TOL


def test_three_epoch_run_matches_jax(tmp_path, monkeypatch, record_property):
    """From JAX's initial checkpoint, at the z radius that a 40 dB alias
    attenuation sets (1 / 0.99888 at nfft 2^12), which also takes the EDR
    loss's envelope; the sub-FDN normalization is well conditioned there.
    On the circle, the prototype run of test_torch_colorless.py."""
    raw = single_pos_raw(tmp_path, True, False, alias_attenuation_db=40.0)
    write_two_slope_wav(tmp_path)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=jdir)))
    jtrainer, _ = jax_run_training_single_pos(jcfg, devices=jax.devices("cpu")[:1])
    init = jax_load_checkpoint(jdir, -1)
    build = port_solver.build_gfdn_model
    monkeypatch.setattr(port_solver, "build_gfdn_model",
                        lambda *a, **kw: load_jax_params(build(*a, **kw), init))
    cfg = DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=pdir)))
    assert cfg.trainer_config.reduced_pole_radius < 1.0
    trainer, model = run_training_single_pos(cfg, device="cpu")
    assert len(trainer.train_loss) == len(jtrainer.train_loss) == 3
    errs = [abs(a - b) / abs(b) for a, b in zip(trainer.train_loss, jtrainer.train_loss)]
    record_property("epoch_loss_rel", errs)
    assert max(errs) <= LOSS_TOL, (trainer.train_loss, jtrainer.train_loss)
    ckpt = jax_load_checkpoint(pdir, 2)
    assert set(ckpt["params"]) == {"input_gains", "output_gains", "output_svf_params",
                                   "input_scalars", "feedback_loop"}
    mat = loadmat(str(tmp_path / "port" / "parameters_opt.mat"))
    assert {"input_scalars", "coupled_feedback_matrix", "input_gains"} <= set(mat)
    assert loadmat(str(tmp_path / "port" / "losses.mat"))["train_loss"].size == 3


def test_cli_fits_a_written_wav_and_refuses_resume(tmp_path, caplog):
    raw = single_pos_raw(tmp_path, False, True, 2, 8, epochs=2, use_freq_parallel=True)
    write_two_slope_wav(tmp_path)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(raw))
    cli_main(["-c", str(path), "--device", "cpu"])
    train_dir = tmp_path / "sp_outFalse_inTrue"
    assert (train_dir / "checkpoints" / "model_e1.ckpt").exists()
    assert (train_dir / "config_args.pickle").exists()
    assert "only one device is visible; training unsharded" in caplog.text
    with pytest.raises(SystemExit):
        cli_main(["-c", str(path), "--device", "cpu", "--resume"])
