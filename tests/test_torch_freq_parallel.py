"""Frequency-sharded single-position fits of the port against its unsharded
fit and against JAX's ``make_freq_sharded_step``.

The ranks are gloo processes on the CPU (``parallel/mesh.spawn``, started once
for the file through a module fixture: worlds 2 and 3, for which F = 1025 at
nfft 2048 divides by neither); they run ``tests/torch_dist_workers.py``,
which imports no JAX. The JAX side runs here on the conftest's virtual CPU
devices, its mesh as large as the port's world. Bounds (ROADMAP C21):

* sharded against unsharded port: loss 1e-6 relative, each gradient 1e-5
  relative L2, the parameters after one Adam step 1e-6; the parameters
  equal across ranks, bit for bit;
* against JAX on the same mesh shape: loss 1e-3, gradients 1e-2, one Adam
  step 1e-6 (C3's bounds);
* ``run_model --freq-parallel on`` under two ranks: the losses and the
  parameters of the one-rank run (1e-6), written by rank 0 only; at world 1
  JAX's warning; ``--profile-dir`` writes a trace.
"""

import logging
import pickle

import jax
import numpy as np
import pytest
from scipy.io import loadmat

from diffgfdn_torch.parallel import spawn
from diffgfdn_tpu.losses import edc_loss as jax_edc_loss
from diffgfdn_tpu.models import DiffGFDNSinglePos as JaxDiffGFDNSinglePos
from diffgfdn_tpu.ops.absorption import decay_times_to_gain_per_sample
from diffgfdn_tpu.parallel import make_freq_sharded_step as jax_make_freq_sharded_step
from diffgfdn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffgfdn_tpu.training.optim import make_optimizer as jax_make_optimizer
from diffgfdn_tpu.utils.cio import decode_batch, encode_batch, init_with_batch
import torch_dist_workers as workers
from torch_port_helpers import rel_l2

WORLDS = (2, 3)
FS = 8000.0
NFFT = 2048
DELAYS = (163, 179, 191, 211, 223, 227)
MIXING, MAX_LEN = 160, 1600
CLI_NFFT = 1024

LOSS_TOL, GRAD_TOL, ADAM_TOL = 1e-6, 1e-5, 1e-6  # sharded vs unsharded port
JAX_LOSS_TOL, JAX_GRAD_TOL = 1e-3, 1e-2  # port vs JAX (C3)


def _jax_fixture():
    """JAX's fixture (``tests/test_freq_parallel.py``): a 6-line single-position
    GFDN with scalar heads, F = 1025, a decaying noise target."""
    gains = np.concatenate([
        np.asarray(decay_times_to_gain_per_sample(t60, np.asarray(DELAYS[2 * k:2 * k + 2]), FS))
        for k, t60 in enumerate((0.05, 0.08, 0.06))])
    model = JaxDiffGFDNSinglePos(sample_rate=FS, num_groups=3, delays=DELAYS, gains=gains,
                                 use_svf_in_output=False)
    f = NFFT // 2 + 1
    t = np.arange(NFFT) / FS
    rir = np.random.RandomState(0).randn(NFFT) * np.exp(-t * 40.0)
    batch = {
        "z_values": np.exp(1j * np.linspace(0, np.pi, f)).astype(np.complex64),
        "listener_position": np.zeros((1, 3), np.float32),
        "norm_listener_position": np.zeros((1, 3), np.float32),
        "target_early_response": np.zeros((1, f), np.complex64),
        "target_rir_response": np.fft.rfft(rir, NFFT)[None].astype(np.complex64),
    }
    params = init_with_batch(model, jax.random.PRNGKey(0), batch)
    return model, gains, batch, params


CLI_YAML = """
seed: 5
ir_path: {wav}
num_groups: 3
sample_rate: {fs}
num_delay_lines: 6
delay_range_ms: [20, 29]
trainer_config:
  batch_size: 1
  num_freq_bins: {nfft}
  max_epochs: 2
  lr: 1.0e-3
  train_dir: {train_dir}
output_filter_config:
  use_svfs: false
  num_hidden_layers: 1
  num_neurons_per_layer: 8
  num_fourier_features: 2
decay_filter_config:
  use_absorption_filters: false
colorless_fdn_config:
  use_colorless_prototype: false
"""


def _write_cli_config(tmp, train_dir: str):
    from diffgfdn_torch.data.audio import write_wav

    t = np.arange(CLI_NFFT) / FS
    rir = (np.random.RandomState(3).randn(CLI_NFFT) * np.exp(-t * 40.0)).astype(np.float32)
    wav = tmp / "ir_(1.00, 2.00, 1.50).wav"
    write_wav(wav, rir, FS)
    path = tmp / f"{train_dir}.yml"
    path.write_text(CLI_YAML.format(wav=wav, fs=FS, nfft=CLI_NFFT,
                                    train_dir=tmp / train_dir))
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: one sharded step at worlds 2 and 3, and the
    CLI under two ranks."""
    out = tmp_path_factory.mktemp("freq_ranks")
    model, gains, batch, params = _jax_fixture()
    port_batch = {k: v for k, v in batch.items() if k != "target_early_response"}
    port_batch["target_early_response"] = batch["target_early_response"][0]
    port_batch["target_rir_response"] = batch["target_rir_response"][0]
    spec = dict(fs=FS, delays=DELAYS, gains=gains, nfft=NFFT, mixing=MIXING, max_len=MAX_LEN,
                params=jax.tree_util.tree_map(np.asarray, params), batch=port_batch)
    with open(out / "freq_step.pkl", "wb") as f:
        pickle.dump(spec, f)
    cli = dict(cwd=str(out), config=str(_write_cli_config(out, "sharded")))
    with open(out / "freq_cli.pkl", "wb") as f:
        pickle.dump(cli, f)
    spawn(workers.freq_pair, 2, "gloo", (str(out),), **workers.SPAWN)
    spawn(workers.freq_step, 3, "gloo", (str(out),), **workers.SPAWN)
    results = {}
    for name, world in (("freq_step", 2), ("freq_step", 3), ("freq_cli", 2)):
        results[name, world] = []
        for rank in range(world):
            with open(out / f"{name}_w{world}_rank{rank}.pkl", "rb") as f:
                results[name, world].append(pickle.load(f))
    return dict(out=out, results=results, model=model, batch=batch, params=params)


@pytest.mark.parametrize("world", WORLDS)
def test_freq_sharded_step_matches_unsharded_port(ranks, world, record_property):
    per_rank = ranks["results"]["freq_step", world]
    sharded, unsharded = per_rank[0]["sharded"], per_rank[0]["unsharded"]
    loss_rel = abs(sharded["loss"] - unsharded["loss"]) / abs(unsharded["loss"])
    grads = {k: rel_l2(sharded["grads"][k], v) for k, v in unsharded["grads"].items()}
    adam = {k: rel_l2(sharded["params"][k], v) for k, v in unsharded["params"].items()}
    record_property("loss_rel", float(loss_rel))
    record_property("worst_grad_rel_l2", float(max(grads.values())))
    record_property("worst_adam_rel_l2", float(max(adam.values())))
    assert loss_rel <= LOSS_TOL
    assert max(grads.values()) <= GRAD_TOL, grads
    assert max(adam.values()) <= ADAM_TOL, adam
    for other in per_rank[1:]:
        assert other["sharded"]["loss"] == sharded["loss"]
        for k, v in sharded["params"].items():
            np.testing.assert_array_equal(other["sharded"]["params"][k], v, err_msg=k)


def _flat(tree):
    return workers.flat(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("world", WORLDS)
def test_freq_sharded_step_matches_jax_on_a_mesh_of_the_same_size(ranks, world,
                                                                   record_property):
    model, batch, params = ranks["model"], ranks["batch"], ranks["params"]

    def loss_fn(p, b, key):
        total = jax_edc_loss(b["target_rir_response"][0], model.apply(p, b), MIXING, MAX_LEN)
        return total, {"edc": total}

    from diffgfdn_tpu.config.schema import TrainerConfig

    cfg = TrainerConfig(batch_size=1, num_freq_bins=NFFT, max_epochs=1, lr=1e-3)
    optimizer = jax_make_optimizer(cfg, params, 1)
    mesh = jax_make_mesh(1, devices=jax.devices("cpu")[:world])
    step = jax_make_freq_sharded_step(model, loss_fn, optimizer, mesh)
    new_params, _, total, _ = step(params, optimizer.init(params), batch, jax.random.PRNGKey(1))
    grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, decode_batch(b), None)[0]))(
        params, encode_batch(batch))
    port = ranks["results"]["freq_step", world][0]["sharded"]
    loss_rel = abs(port["loss"] - float(total)) / abs(float(total))
    grad_errs = {k: rel_l2(port["grads"][k], v) for k, v in _flat(grads).items()}
    adam = {k: rel_l2(port["params"][k], v) for k, v in _flat(new_params).items()}
    record_property("loss_rel", float(loss_rel))
    record_property("worst_grad_rel_l2", float(max(grad_errs.values())))
    record_property("worst_adam_rel_l2", float(max(adam.values())))
    assert loss_rel <= JAX_LOSS_TOL
    assert max(grad_errs.values()) <= JAX_GRAD_TOL, grad_errs
    assert max(adam.values()) <= ADAM_TOL, adam


def test_cli_two_ranks_train_as_one_and_write_once(ranks, tmp_path, monkeypatch,
                                                   record_property):
    from diffgfdn_torch.cli.run_model import main

    per_rank = ranks["results"]["freq_cli", 2]
    assert per_rank[0]["writes"] == [-1, 0, 1] and per_rank[1]["writes"] == []
    for r in per_rank:
        assert any("sharding the rFFT bin axis over 2 devices" in m for m in r["messages"])
        assert any("frequency axis sharded over 2 ranks" in m for m in r["messages"])
        assert not any("only one device is visible" in m for m in r["messages"])
    monkeypatch.chdir(ranks["out"])
    main(["-c", str(_write_cli_config(ranks["out"], "one_rank")), "--device", "cpu",
          "--freq-parallel", "off"])
    out = ranks["out"]
    two = loadmat(str(out / "sharded" / "losses.mat"))["train_loss"].ravel()
    one = loadmat(str(out / "one_rank" / "losses.mat"))["train_loss"].ravel()
    loss_rel = float(np.max(np.abs(two - one) / np.abs(one)))
    record_property("loss_rel", float(loss_rel))
    assert two.shape == (2,) and loss_rel <= LOSS_TOL
    p_two = loadmat(str(out / "sharded" / "parameters_opt.mat"))
    p_one = loadmat(str(out / "one_rank" / "parameters_opt.mat"))
    keys = [k for k in p_one if not k.startswith("__")]
    assert keys and all(rel_l2(p_two[k], p_one[k]) <= ADAM_TOL for k in keys)


def test_cli_warns_at_world_one_and_writes_a_profile(ranks, tmp_path, monkeypatch, caplog):
    from diffgfdn_torch.cli.run_model import main

    monkeypatch.chdir(tmp_path)
    cfg = _write_cli_config(tmp_path, "world_one")
    with caplog.at_level(logging.INFO, logger="diffgfdn_torch"):
        main(["-c", str(cfg), "--device", "cpu", "--freq-parallel", "on"])
    assert any("only one device is visible" in r.message for r in caplog.records)
    assert not any("sharding the rFFT bin axis" in r.message for r in caplog.records)
    prof = tmp_path / "prof"
    main(["-c", str(cfg), "--device", "cpu", "--freq-parallel", "off",
          "--profile-dir", str(prof)])
    assert (prof / "trace.json").stat().st_size > 0
