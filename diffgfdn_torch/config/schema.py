"""Config schema as stdlib dataclasses, YAML-compatible with the JAX package.

Field names, nesting and defaults are those of ``diffgfdn_tpu/config/schema.py``
so the same YAML presets load in both packages. pydantic is not available
everywhere the port runs, so validation is done here by hand:

* every nested dict is coerced into its dataclass, enum strings into enums,
  numbers into the annotated type;
* unknown keys raise ``ValueError`` naming the key, at every level (the JAX
  schema forbids them at the top level only);
* ``delay_length_samps`` and its prime helpers are verbatim copies of the JAX
  schema, so the same seed draws the same delays.
"""

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
import types
import typing
from typing import List, Literal, Optional, Tuple

import numpy as np


class CouplingMatrixType(Enum):
    """Types of coupling matrix in the GFDN feedback loop."""

    SCALAR = "scalar_matrix"    # unitary scalar coupling (Givens angles)
    FILTER = "filter_matrix"    # FIR paraunitary polynomial coupling
    RANDOM = "random_matrix"    # unstructured orthogonal feedback matrix


class FeatureEncodingType(Enum):
    """Position-feature encodings for the conditioning MLPs."""

    SINE = "sinusoidal"
    MESHGRID = "meshgrid"


class BeamformerType(Enum):
    """Beamformer used to convert SH-domain weights to directional gains."""

    BUTTER = "butterworth"
    MAX_DI = "max_directivity"
    MAX_RE = "max_re"


def _coerce(value, tp, where: str):
    """Convert ``value`` to the annotated type ``tp`` or raise naming ``where``."""
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin in (typing.Union, types.UnionType):
        if value is None and type(None) in args:
            return None
        (inner,) = [a for a in args if a is not type(None)]
        return _coerce(value, inner, where)
    if origin is Literal:
        if value not in args:
            raise ValueError(f"{where}: {value!r} is not one of {args}")
        return value
    if origin in (list, List):
        return [_coerce(v, args[0], where) for v in value]
    if origin in (tuple, Tuple):
        if len(value) != len(args):
            raise ValueError(f"{where}: expected {len(args)} values, got {value!r}")
        return tuple(_coerce(v, a, where) for v, a in zip(value, args))
    if isinstance(tp, type) and issubclass(tp, _Config):
        if isinstance(value, tp):
            return value
        if isinstance(value, dict):
            return tp.from_dict(value)
        raise ValueError(f"{where}: expected a mapping, got {value!r}")
    if isinstance(tp, type) and issubclass(tp, Enum):
        return value if isinstance(value, tp) else tp(value)
    if tp is bool:
        if not isinstance(value, (bool, np.bool_)):
            raise ValueError(f"{where}: expected a bool, got {value!r}")
        return bool(value)
    if tp is int:
        if isinstance(value, bool) or int(value) != value:
            raise ValueError(f"{where}: expected an int, got {value!r}")
        return int(value)
    if tp is float:
        if isinstance(value, bool):
            raise ValueError(f"{where}: expected a number, got {value!r}")
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            raise ValueError(f"{where}: expected a string, got {value!r}")
        return value
    raise TypeError(f"{where}: unsupported annotation {tp!r}")


@dataclass
class _Config:
    """Base: coerce every field to its annotation, then validate."""

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            where = f"{type(self).__name__}.{f.name}"
            setattr(self, f.name, _coerce(getattr(self, f.name), hints[f.name], where))
        self._validate()

    def _validate(self) -> None:
        """Cross-field checks (the pydantic model validators)."""

    @classmethod
    def from_dict(cls, raw: Optional[dict]):
        """Build from a mapping, rejecting keys the schema does not know."""
        raw = dict(raw or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown config keys {unknown}")
        return cls(**raw)


@dataclass
class FeedbackLoopConfig(_Config):
    """Feedback-loop (coupled feedback matrix) options."""

    pu_matrix_order: int = 2 ** 5
    coupling_matrix_type: CouplingMatrixType = CouplingMatrixType.SCALAR
    use_zero_coupling: bool = True


@dataclass
class MLPTuningConfig(_Config):
    """Hyperparameter sweep ranges for the conditioning MLP."""

    tune_hyperparameters: bool = True
    min_layers: int = 1
    max_layers: int = 20
    min_neurons: int = 2 ** 4
    max_neurons: int = 2 ** 7
    step_size: int = 2 ** 4
    num_trials: int = 50
    sampler: Literal["tpe", "random", "optuna"] = "tpe"
    trial_epochs: Optional[int] = 2


@dataclass
class SubbandProcessingConfig(_Config):
    """Config for running one DiffGFDN per octave subband."""

    centre_frequency: float
    frequency_range: Tuple[float, float]
    num_fraction_octaves: int = 3
    use_amp_preserving_filterbank: bool = True


@dataclass
class OutputFilterConfig(_Config):
    """Position-conditioned output (or input) gain/filter head."""

    use_svfs: bool = True
    compress_pole_factor: float = 1.0
    mlp_tuning_config: Optional[MLPTuningConfig] = None
    num_hidden_layers: int = 3
    num_neurons_per_layer: int = 2 ** 7
    num_fourier_features: int = 10
    encoding_type: FeatureEncodingType = FeatureEncodingType.SINE
    beamformer_type: Optional[BeamformerType] = None
    use_skip_connections: bool = False


@dataclass
class DecayFilterConfig(_Config):
    """Delay-line absorption configuration."""

    use_absorption_filters: bool = True
    learn_common_decay_times: bool = False
    initialise_with_opt_values: bool = True


@dataclass
class TestSetConfig(_Config):
    """Held-out test split config."""

    __test__ = False  # not a pytest class

    seed: int = 4314
    ratio: float = 0.1


@dataclass
class TrainerConfig(_Config):
    """Training hyperparameters."""

    batch_size: int = 32
    num_freq_bins: Optional[int] = None
    device: Optional[str] = "tpu"  # accepted for YAML parity; unused
    train_valid_split: Optional[float] = 0.8
    hold_out_test_set: Optional[TestSetConfig] = None
    grid_resolution_m: Optional[float] = None
    max_epochs: int = 5
    lr: float = 0.01
    io_lr: float = 0.01
    coupling_angle_lr: float = 0.01
    output_filt_ir_len_ms: float = 500
    use_reg_loss: bool = False
    use_erb_edr_loss: bool = False
    use_colorless_loss: bool = False
    use_asym_spectral_loss: bool = False
    edc_loss_weight: float = 1.0
    edr_loss_weight: float = 1.0
    spectral_loss_weight: float = 1.0
    sparsity_loss_weight: float = 1.0
    use_edc_mask: bool = False
    use_frequency_weighting: bool = False
    subband_process_config: Optional[SubbandProcessingConfig] = None
    use_freq_parallel: Optional[bool] = None
    train_dir: str = "output/tpu/"
    ir_dir: str = "audio/tpu/"
    save_true_irs: bool = False
    alias_attenuation_db: Optional[int] = None
    reduced_pole_radius: float = 1.0

    def _validate(self) -> None:
        """reduced_pole_radius = 10^(-|attn_db| / nfft / 20)."""
        if self.alias_attenuation_db is not None:
            if self.num_freq_bins is None:
                raise ValueError(
                    "alias_attenuation_db requires num_freq_bins: the "
                    "reduced pole radius is 10^(-attn/nfft/20)"
                )
            self.reduced_pole_radius = 10 ** (
                -abs(self.alias_attenuation_db) / self.num_freq_bins / 20
            )


@dataclass
class ColorlessFDNConfig(_Config):
    """Colorless (lossless-prototype) FDN pre-optimisation config."""

    use_colorless_prototype: bool = False
    batch_size: int = 2000
    max_epochs: int = 20
    train_valid_split: float = 0.8
    lr: float = 0.01
    alpha: float = 1.0
    saved_param_path: Optional[str] = None

    @property
    def load_fixed_parameters(self) -> bool:
        """Whether to load pre-saved A, b, c."""
        return self.saved_param_path is not None


@dataclass
class DiffGFDNConfig(_Config):
    """Top-level training and serving config."""

    seed: int = 46434
    room_dataset_path: str = "resources/Georg_3room_FDTD/srirs.pkl"
    num_groups: int = 3
    ir_path: Optional[str] = None
    sample_rate: float = 32000.0
    trainer_config: TrainerConfig = field(default_factory=TrainerConfig)
    delay_range_ms: List[float] = field(default_factory=lambda: [20.0, 50.0])
    ambi_order: Optional[int] = None
    num_delay_lines: Optional[int] = 12
    feedback_loop_config: FeedbackLoopConfig = field(default_factory=FeedbackLoopConfig)
    decay_filter_config: DecayFilterConfig = field(default_factory=DecayFilterConfig)
    output_filter_config: OutputFilterConfig = field(default_factory=OutputFilterConfig)
    input_filter_config: Optional[OutputFilterConfig] = field(
        default_factory=OutputFilterConfig
    )
    colorless_fdn_config: ColorlessFDNConfig = field(default_factory=ColorlessFDNConfig)

    def _validate(self) -> None:
        # directional FDNs need (ambi_order+1)^2 delay lines per group
        if self.ambi_order is not None:
            self.num_delay_lines = ((self.ambi_order + 1) ** 2) * self.num_groups
        # grid-resolution splits only make sense for directional FDNs
        if self.trainer_config.grid_resolution_m is not None:
            if self.ambi_order is None:
                raise AttributeError(
                    "Only use grid resolution for directional reverberation training!"
                )
            self.trainer_config.train_valid_split = None

    @property
    def delay_length_samps(self) -> List[int]:
        """Co-prime (prime) delay-line lengths drawn from the delay range.

        A seeded permutation of the primes inside [delay_range_ms], topped
        with the next prime above the range (verbatim from the JAX schema).
        """
        lo = int(self.delay_range_ms[0] * 1e-3 * self.sample_rate)
        hi = int(self.delay_range_ms[1] * 1e-3 * self.sample_rate)
        primes = _primes_in_range(lo, hi)
        rng = np.random.RandomState(self.seed)
        rand_primes = np.asarray(primes, dtype=np.int64)[
            rng.permutation(len(primes))
        ]
        if len(rand_primes) < self.num_delay_lines - 1:
            raise ValueError(
                f"delay_range_ms={list(self.delay_range_ms)} at "
                f"fs={self.sample_rate:g} contains only {len(rand_primes)} "
                f"primes but num_delay_lines={self.num_delay_lines} needs "
                f"{self.num_delay_lines - 1} — widen the range (a silent "
                "truncation would break the per-group channel layout)"
            )
        delays = list(rand_primes[: self.num_delay_lines - 1])
        delays.append(_next_prime(hi))
        return [int(d) for d in delays]


# ------------------------------ prime helpers -------------------------------


def _primes_in_range(lo: int, hi: int) -> List[int]:
    """All primes p with lo <= p < hi (simple sieve; ranges are tiny)."""
    if hi <= 2:
        return []
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(hi ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    primes = np.nonzero(sieve)[0]
    return [int(p) for p in primes if p >= lo]


def _next_prime(n: int) -> int:
    """Smallest prime strictly greater than n."""
    cand = n + 1
    while True:
        if cand >= 2 and all(cand % p for p in range(2, int(cand ** 0.5) + 1)):
            return cand
        cand += 1
