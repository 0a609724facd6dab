"""MLP hyperparameter search: TPE, random, or optuna when available (port of
``training/hypertuning.py``).

The search proposes (num_hidden_layers, num_neurons_per_layer) of the
output-head MLP, trains the model per trial through the caller's
``train_fn`` and keeps the architecture with the least objective. Three
samplers:

* ``tpe`` (default): a dependency-free Tree-structured Parzen Estimator for
  the discrete 2-D space (Bergstra et al. 2011): trials are split at the
  gamma-quantile into good and bad sets, per-dimension smoothed categorical
  densities l(x) and g(x) are fit to each, candidates are drawn from l and
  the one with the highest likelihood ratio is evaluated next;
* ``random``: seeded random search;
* ``optuna``: the library, used when importable (falls back to ``tpe``).

The proposals come from ``np.random.RandomState(seed)`` in the JAX
package's call order, so both packages evaluate the same architectures,
trial for trial.
"""

import copy
from dataclasses import dataclass
import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..config.schema import DiffGFDNConfig, MLPTuningConfig

logger = logging.getLogger("diffgfdn_torch")


@dataclass
class TrialResult:
    num_hidden_layers: int
    num_neurons_per_layer: int
    objective: float


def _search_space(tcfg: MLPTuningConfig) -> Tuple[np.ndarray, np.ndarray]:
    layers = np.arange(tcfg.min_layers, tcfg.max_layers + 1)
    neurons = np.arange(tcfg.min_neurons, tcfg.max_neurons + 1, tcfg.step_size)
    return layers, neurons


def sample_trial(rng: np.random.RandomState, tcfg: MLPTuningConfig) -> Tuple[int, int]:
    """One uniform (layers, neurons) draw from the configured ranges."""
    layers, neurons = _search_space(tcfg)
    return int(layers[rng.randint(len(layers))]), int(neurons[rng.randint(len(neurons))])


def _smoothed_pmf(values: Sequence[int], support: np.ndarray) -> np.ndarray:
    """Laplace-smoothed categorical density of the observed ``values``."""
    counts = np.array([np.sum(np.asarray(values) == v) for v in support], float)
    return (counts + 1.0) / (counts.sum() + len(support))


def tpe_propose(
    rng: np.random.RandomState,
    tcfg: MLPTuningConfig,
    results: List[TrialResult],
    seen: set,
    gamma: float = 0.25,
    n_candidates: int = 24,
    n_startup: int = 4,
) -> Tuple[int, int]:
    """Next (layers, neurons) by the TPE criterion; random during startup."""
    layers_sup, neurons_sup = _search_space(tcfg)
    if len(results) < n_startup:
        return sample_trial(rng, tcfg)

    order = sorted(results, key=lambda r: r.objective)
    n_good = max(1, int(np.ceil(gamma * len(order))))
    good, bad = order[:n_good], order[n_good:] or order[:n_good]

    dims = (("num_hidden_layers", layers_sup), ("num_neurons_per_layer", neurons_sup))
    l_pmf, g_pmf = [], []
    for attr, support in dims:
        l_pmf.append(_smoothed_pmf([getattr(r, attr) for r in good], support))
        g_pmf.append(_smoothed_pmf([getattr(r, attr) for r in bad], support))

    best_score, best = -np.inf, None
    for _ in range(n_candidates):
        li = rng.choice(len(layers_sup), p=l_pmf[0])
        ni = rng.choice(len(neurons_sup), p=l_pmf[1])
        cand = (int(layers_sup[li]), int(neurons_sup[ni]))
        score = (l_pmf[0][li] / g_pmf[0][li]) * (l_pmf[1][ni] / g_pmf[1][ni])
        if cand in seen:  # already evaluated: deprioritize
            score -= 1e6
        if score > best_score:
            best_score, best = score, cand
    return best


def _candidate(config: DiffGFDNConfig, layers: int, neurons: int) -> DiffGFDNConfig:
    """A deep copy of ``config`` with the output MLP's architecture set."""
    cand = copy.deepcopy(config)
    cand.output_filter_config.num_hidden_layers = layers
    cand.output_filter_config.num_neurons_per_layer = neurons
    return cand


def _optuna_search(
    config: DiffGFDNConfig,
    train_fn: Callable[[DiffGFDNConfig], float],
    tcfg: MLPTuningConfig,
    num_trials: int,
    seed: int,
) -> List[TrialResult]:
    import optuna

    results: List[TrialResult] = []

    def objective(trial):
        layers = trial.suggest_int("num_hidden_layers", tcfg.min_layers, tcfg.max_layers)
        neurons = trial.suggest_int(
            "num_neurons", tcfg.min_neurons, tcfg.max_neurons, step=tcfg.step_size
        )
        value = float(train_fn(_candidate(config, layers, neurons)))
        results.append(TrialResult(layers, neurons, value))
        return value

    study = optuna.create_study(
        direction="minimize", sampler=optuna.samplers.TPESampler(seed=seed)
    )
    study.optimize(objective, n_trials=num_trials)
    return results


def mlp_hyperparameter_tuning(
    config: DiffGFDNConfig,
    train_fn: Callable[[DiffGFDNConfig], float],
    num_trials: Optional[int] = None,
    seed: int = 0,
    sampler: Optional[str] = None,
) -> Tuple[DiffGFDNConfig, List[TrialResult]]:
    """Search the output-MLP architecture, minimizing ``train_fn(config)``.

    Returns the best config and the trial history. ``sampler`` overrides
    the config's choice ("tpe" | "random" | "optuna").
    """
    tcfg = config.output_filter_config.mlp_tuning_config or MLPTuningConfig()
    num_trials = num_trials or tcfg.num_trials
    sampler = sampler or tcfg.sampler
    rng = np.random.RandomState(seed)

    if sampler not in ("tpe", "random", "optuna"):
        raise ValueError(f"unknown sampler {sampler!r}: expected 'tpe', 'random' or 'optuna'")
    if sampler == "optuna":
        try:
            results = _optuna_search(config, train_fn, tcfg, num_trials, seed)
        except ImportError:
            logger.warning("optuna not installed; falling back to tpe")
            sampler = "tpe"
    if sampler in ("tpe", "random"):
        seen = set()
        results = []
        all_layers, all_neurons = _search_space(tcfg)
        space_size = len(all_layers) * len(all_neurons)
        for trial in range(num_trials):
            if len(seen) >= space_size:
                logger.info("search space exhausted after %d unique trials", len(seen))
                break
            # duplicates are drawn again, not charged to the budget
            for _ in range(100):
                if sampler == "tpe":
                    layers, neurons = tpe_propose(rng, tcfg, results, seen)
                else:
                    layers, neurons = sample_trial(rng, tcfg)
                if (layers, neurons) not in seen:
                    break
            else:  # the sampler keeps proposing seen points: take any unseen one
                layers, neurons = next(
                    (int(lay), int(neu))
                    for lay in all_layers
                    for neu in all_neurons
                    if (int(lay), int(neu)) not in seen
                )
            seen.add((layers, neurons))
            objective = float(train_fn(_candidate(config, layers, neurons)))
            results.append(TrialResult(layers, neurons, objective))
            logger.info("trial %d (%s): layers=%d neurons=%d objective=%.4f",
                        trial, sampler, layers, neurons, objective)

    best = min(results, key=lambda r: r.objective)
    return _candidate(config, best.num_hidden_layers, best.num_neurons_per_layer), results
