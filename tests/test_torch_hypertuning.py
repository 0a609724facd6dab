"""The MLP hyperparameter search in the port against JAX's ``training/hypertuning.py``.

* The proposals: with the configs and fake objectives of the JAX package's
  own tests (``tests/test_cli_and_analysis.py``), the port's TPE and random
  samplers evaluate the same architectures in the same order, trial for
  trial, with the same objectives and the same winner; the ``optuna``
  sampler falls back to TPE (optuna is not installed) as JAX's does.
* The solver: ``run_training_var_receiver_pos`` with an ``mlp_tuning_config``
  (sampler ``random``, 2 trials of 1 epoch, or 1 in the quick set; fs 8 kHz,
  nfft 2^12, a narrow
  scalar-head model), each trial of the port started from JAX's initial
  parameters of the same architecture: the same architectures, objectives
  within 1e-3 relative (C3's epoch-0 bound), the same winner unless the two
  best objectives lie within that bound of each other; the winner is
  trained with its ``mlp_tuning_config`` set to None.
"""

import jax
import numpy as np
import pytest

from diffgfdn_torch.config.schema import DiffGFDNConfig
from diffgfdn_torch.training import hypertuning, run_training_var_receiver_pos
from diffgfdn_torch.training import solver as port_solver
from diffgfdn_torch.utils.params import load_jax_params
from diffgfdn_tpu.config.schema import DiffGFDNConfig as JaxDiffGFDNConfig
from diffgfdn_tpu.training import hypertuning as jax_hypertuning
from diffgfdn_tpu.training import solver as jax_solver
from torch_port_helpers import raw_config, rooms

OBJECTIVE_TOL = 1e-3
SEARCHES = {
    # (tuning config, seed, the objective's optimum (layers, neurons))
    "random": (dict(min_layers=1, max_layers=4, min_neurons=16, max_neurons=64, step_size=16,
                    num_trials=6, sampler="random"), 0, (2, 32)),
    "tpe": (dict(min_layers=1, max_layers=8, min_neurons=16, max_neurons=128, step_size=16,
                 num_trials=20, sampler="tpe"), 1, (3, 64)),
    "optuna": (dict(min_layers=1, max_layers=2, min_neurons=16, max_neurons=32, step_size=16,
                    num_trials=4, sampler="optuna"), 0, (1, 16)),
}


def _search(package_config, tuning: dict, seed: int, optimum):
    cfg = package_config(dict(output_filter_config=dict(mlp_tuning_config=tuning)))
    evaluated = []

    def objective(c):
        layers = c.output_filter_config.num_hidden_layers
        neurons = c.output_filter_config.num_neurons_per_layer
        evaluated.append((layers, neurons))
        return abs(layers - optimum[0]) + abs(neurons - optimum[1]) / 16.0

    module = jax_hypertuning if package_config is JaxDiffGFDNConfig.model_validate else hypertuning
    best, results = module.mlp_hyperparameter_tuning(cfg, objective, seed=seed)
    trials = [(r.num_hidden_layers, r.num_neurons_per_layer, r.objective) for r in results]
    winner = (best.output_filter_config.num_hidden_layers,
              best.output_filter_config.num_neurons_per_layer)
    return evaluated, trials, winner


@pytest.mark.parametrize("sampler", list(SEARCHES))
def test_proposals_equal_jax_trial_for_trial(sampler):
    tuning, seed, optimum = SEARCHES[sampler]
    ref = _search(JaxDiffGFDNConfig.model_validate, tuning, seed, optimum)
    got = _search(DiffGFDNConfig.from_dict, tuning, seed, optimum)
    assert got == ref
    evaluated, trials, winner = got
    assert len(trials) == tuning["num_trials"] and len(set(evaluated)) == len(evaluated)
    assert winner == min(trials, key=lambda t: t[2])[:2]
    if sampler == "tpe":  # the optimum is found, as JAX's own test asks
        assert winner == optimum


def test_unknown_sampler_raises():
    cfg = DiffGFDNConfig.from_dict(dict(output_filter_config=dict(mlp_tuning_config={})))
    with pytest.raises(ValueError, match="unknown sampler"):
        hypertuning.mlp_hyperparameter_tuning(cfg, lambda c: 0.0, sampler="grid")


@pytest.mark.parametrize("trials", [1, pytest.param(2, marks=pytest.mark.slow)])
def test_solver_search_matches_jax(tmp_path, monkeypatch, trials, record_property):
    raw = raw_config(tmp_path, svf=False, nfft=4096, batch=4)
    raw["output_filter_config"]["mlp_tuning_config"] = dict(
        min_layers=1, max_layers=3, min_neurons=8, max_neurons=24, step_size=8,
        num_trials=trials, sampler="random", trial_epochs=1)
    raw["trainer_config"]["max_epochs"] = 1
    jax_room, port_room = rooms(tmp_path, False, 4096)
    inits, searches = {}, {}

    def recording_init(init):
        def wrapped(model, key, batch):
            params = init(model, key, batch)
            # a copy: JAX's trainer donates the initial parameters
            inits[(model.num_hidden_layers, model.num_neurons)] = jax.tree_util.tree_map(
                np.array, params)
            return params
        return wrapped

    def recording_search(module, side):
        search = module.mlp_hyperparameter_tuning

        def wrapped(config, train_fn, **kw):
            best, results = search(config, train_fn, **kw)
            searches[side] = [(r.num_hidden_layers, r.num_neurons_per_layer, r.objective)
                              for r in results]
            return best, results
        monkeypatch.setattr(module, "mlp_hyperparameter_tuning", wrapped)

    def jax_initialized(build):
        def wrapped(config, *args, **kw):
            out = config.output_filter_config
            model = build(config, *args, **kw)
            return load_jax_params(model, inits[(out.num_hidden_layers,
                                                 out.num_neurons_per_layer)])
        return wrapped

    monkeypatch.setattr(jax_solver, "init_with_batch", recording_init(jax_solver.init_with_batch))
    monkeypatch.setattr(port_solver, "build_gfdn_model",
                        jax_initialized(port_solver.build_gfdn_model))
    recording_search(jax_hypertuning, "jax")
    recording_search(hypertuning, "port")
    jcfg = JaxDiffGFDNConfig.model_validate(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=str(tmp_path / "jax"))))
    jtrainer, _ = jax_solver.run_training_var_receiver_pos(jcfg, room_data=jax_room)
    cfg = DiffGFDNConfig.from_dict(
        dict(raw, trainer_config=dict(raw["trainer_config"], train_dir=str(tmp_path / "port"))))
    trainer, model = run_training_var_receiver_pos(cfg, port_room, device="cpu")

    ref, got = searches["jax"], searches["port"]
    assert [t[:2] for t in got] == [t[:2] for t in ref] and len(got) == trials
    errs = [abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(got, ref)]
    record_property("objective_rel", errs)
    assert max(errs) <= OBJECTIVE_TOL, (got, ref)
    best_ref = sorted(ref, key=lambda t: t[2])
    if len(ref) < 2 or (abs(best_ref[1][2] - best_ref[0][2])
                        > OBJECTIVE_TOL * abs(best_ref[0][2])):
        assert min(got, key=lambda t: t[2])[:2] == best_ref[0][:2]
    layers, neurons = min(got, key=lambda t: t[2])[:2]
    head = model.output_scalars.mlp
    assert len(head.dense) == layers + 2 and head.dense[0].out_features == neurons
    assert (tmp_path / "port" / "tuning" / "checkpoints").is_dir()
    assert len(trainer.train_loss) == len(jtrainer.train_loss) == 1
    err = abs(trainer.train_loss[0] - jtrainer.train_loss[0]) / abs(jtrainer.train_loss[0])
    record_property("winner_loss_rel", err)
    assert err <= OBJECTIVE_TOL
    assert np.isfinite(trainer.valid_loss).all()
