"""Model construction from a config and dataset metadata (port of ``training/build.py``).

Host-side: fits the absorption filters (GEQ, or warped Prony) or gains once, resolves the
colorless warm start (a host matrix logarithm, so that the skew
parametrization starts at the prototypes' optimized matrices), then builds a
:class:`DiffGFDNVarReceiverPos` (``variant="var_receiver"``), a
:class:`DiffGFDNVarSourceReceiverPos` (``variant="var_source_receiver"``:
input heads from ``input_filter_config``, or like the output heads when it
is None), a :class:`DiffGFDNSinglePos` (``variant="single_pos"``) or a
:class:`DiffDirectionalFDNVarReceiverPos` (``variant="directional"``, with
the analysis matrix designed for the dataset's directions) with parameters
drawn from a seeded ``torch.Generator``, and moves it to the device.
:func:`build_colorless_fdn` builds one group's prototype.

The prototypes' results are pickled per group as :class:`ColorlessFDNResults`.
The JAX package's pickles name its own class; :func:`load_colorless_result`
reads them as this package's class, without importing the JAX package.
"""

from dataclasses import dataclass
from pathlib import Path
import pickle
from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.linalg import logm
import torch

from ..config.schema import CouplingMatrixType, DiffGFDNConfig
from ..models import (
    ColorlessFDN,
    DiffDirectionalFDNVarReceiverPos,
    DiffGFDNSinglePos,
    DiffGFDNVarReceiverPos,
    DiffGFDNVarSourceReceiverPos,
)
from ..models.spatial import build_analysis_matrix
from ..ops.absorption import (
    decay_times_to_gain_filters_geq,
    decay_times_to_gain_filters_prony,
    decay_times_to_gain_per_sample,
)
from ..utils.device import resolve_device


@dataclass
class ColorlessFDNResults:
    """Optimized lossless-prototype parameters of one group."""

    opt_input_gains: np.ndarray
    opt_output_gains: np.ndarray
    opt_feedback_matrix: np.ndarray


class _ResultsUnpickler(pickle.Unpickler):
    """Reads :class:`ColorlessFDNResults` pickles of either package as this
    package's class; refuses every other class of the JAX package."""

    def find_class(self, module: str, name: str):
        if name == "ColorlessFDNResults" and module in ("diffgfdn_tpu.training.build",
                                                         __name__):
            return ColorlessFDNResults
        if module.split(".")[0] == "diffgfdn_tpu":
            raise pickle.UnpicklingError(f"refusing {module}.{name}: not a colorless result")
        return super().find_class(module, name)


def load_colorless_result(path: Union[str, Path]) -> ColorlessFDNResults:
    """One group's pickled prototype results, written by either package."""
    with open(path, "rb") as f:
        return _ResultsUnpickler(f).load()


def colorless_result_path(directory: Union[str, Path], group_idx: int) -> Path:
    """``<directory>/parameters_opt_group={group_idx + 1}.pkl``, as both packages name it."""
    return Path(directory) / f"parameters_opt_group={group_idx + 1}.pkl"


def skew_preimage(orthogonal: np.ndarray) -> np.ndarray:
    """X such that exp(skew(X)) equals ``orthogonal`` (a host matrix
    logarithm, projected to exact skew symmetry; skew() reads the strict
    upper triangle only)."""
    s = np.real(logm(np.asarray(orthogonal, np.float64)))
    s = 0.5 * (s - s.T)
    return np.triu(s, k=1).astype(np.float32)


def colorless_to_init(
    colorless_params: List[ColorlessFDNResults],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input_gains (N, 1), output_gains (N, 1), M skew pre-images (G, Nper,
    Nper)) stacked over the groups."""
    b = np.concatenate([np.asarray(p.opt_input_gains).reshape(-1) for p in colorless_params])
    c = np.concatenate([np.asarray(p.opt_output_gains).reshape(-1) for p in colorless_params])
    m_skew = np.stack([skew_preimage(p.opt_feedback_matrix) for p in colorless_params])
    return b[:, None].astype(np.float32), c[:, None].astype(np.float32), m_skew


def load_colorless_fdn_params(
    config: DiffGFDNConfig, colorless_dir: Optional[str] = None
) -> List[ColorlessFDNResults]:
    """Every group's pickled prototype results, from ``colorless_dir`` or
    ``<train_dir>/colorless-fdn``."""
    if colorless_dir is None:
        colorless_dir = str(Path(config.trainer_config.train_dir) / "colorless-fdn")
    return [load_colorless_result(colorless_result_path(colorless_dir, k))
            for k in range(config.num_groups)]


def absorption_arrays(
    config: DiffGFDNConfig,
    common_decay_times: Optional[np.ndarray],
    band_centre_hz: Optional[np.ndarray],
    use_prony: bool = False,
) -> dict:
    """Resolve the absorption configuration -> the :class:`FeedbackLoop`
    keywords ``gains``, ``sos_coeffs``, ``iir_coeffs``,
    ``learn_common_decay_times`` and ``common_decay_times_init``.

    ``common_decay_times``: (num_bands, num_groups) for filters (GEQ cascades,
    or warped-Prony IIR filters with ``use_prony``), or (num_groups,)
    broadband for per-line gains. None, or ``learn_common_decay_times`` in
    the config, makes the decay times learnable: started at the given ones
    with ``initialise_with_opt_values`` (per-band ones averaged over the
    bands), else drawn at random.
    """
    dcfg = config.decay_filter_config
    delays = np.asarray(config.delay_length_samps)
    nper = len(delays) // config.num_groups
    kw = dict(gains=None, sos_coeffs=None, iir_coeffs=None, learn_common_decay_times=False,
              common_decay_times_init=None)
    if common_decay_times is None or dcfg.learn_common_decay_times:
        kw["learn_common_decay_times"] = True
        if common_decay_times is not None and dcfg.initialise_with_opt_values:
            cdt = np.asarray(common_decay_times)
            if cdt.ndim == 2 and cdt.shape[0] > 1 and cdt.shape[1] == config.num_groups:
                cdt = cdt.mean(axis=0)  # per band: each group's mean over the bands
            else:
                cdt = cdt.reshape(-1)[: config.num_groups]
            kw["common_decay_times_init"] = tuple(float(t) for t in cdt)
        return kw
    # keep the band axis even for single-group configs
    cdt = np.asarray(common_decay_times)
    if not (cdt.ndim == 2 and cdt.shape[0] > 1 and cdt.shape[1] == config.num_groups):
        cdt = np.squeeze(cdt)
    if dcfg.use_absorption_filters and cdt.ndim == 2:
        fit = decay_times_to_gain_filters_prony if use_prony else decay_times_to_gain_filters_geq
        coeffs = np.concatenate([
            fit(band_centre_hz, cdt[:, g], delays[g * nper : (g + 1) * nper], config.sample_rate)
            for g in range(config.num_groups)
        ], axis=0)
        kw["iir_coeffs" if use_prony else "sos_coeffs"] = coeffs
    else:
        cdt = np.atleast_1d(cdt).reshape(-1)[: config.num_groups]
        kw["gains"] = np.concatenate(
            [
                decay_times_to_gain_per_sample(
                    float(cdt[g]), delays[g * nper : (g + 1) * nper], config.sample_rate
                )
                for g in range(config.num_groups)
            ]
        )
    return kw


def build_gfdn_model(
    config: DiffGFDNConfig,
    common_decay_times: Optional[np.ndarray] = None,
    band_centre_hz: Optional[np.ndarray] = None,
    variant: str = "var_receiver",
    device: Union[str, torch.device] = "cuda",
    desired_directions: Optional[np.ndarray] = None,
    colorless_params: Optional[List[ColorlessFDNResults]] = None,
) -> Union[DiffGFDNVarReceiverPos, DiffGFDNVarSourceReceiverPos, DiffGFDNSinglePos,
           DiffDirectionalFDNVarReceiverPos]:
    """Build the configured model on ``device``, parameters drawn from a
    ``torch.Generator`` seeded with ``config.seed``. The directional variant
    needs ``desired_directions`` (2, J), the dataset's (azimuth, elevation).
    ``colorless_params``, one result per group, fix the io gains and start
    each group's feedback block at its prototype's matrix. FILTER coupling
    takes its order from ``feedback_loop_config.pu_matrix_order``.
    """
    dev = resolve_device(device)
    if variant not in ("var_receiver", "var_source_receiver", "single_pos", "directional"):
        raise ValueError(f"unknown variant {variant}")
    fl_cfg = config.feedback_loop_config
    if (config.trainer_config.use_colorless_loss
            and fl_cfg.coupling_matrix_type is CouplingMatrixType.RANDOM):
        raise ValueError(
            "use_colorless_loss requires block-structured coupling (SCALAR/FILTER): "
            "coupling_matrix_type=RANDOM has no per-group sub-FDNs to evaluate the "
            "colorless loss on"
        )
    kw = absorption_arrays(config, common_decay_times, band_centre_hz)
    if colorless_params is not None:
        b, c, m_skew = colorless_to_init(colorless_params)
        kw.update(fixed_input_gains=b, fixed_output_gains=c,
                  colorless_feedback_matrix_skew=m_skew)
    out_cfg = config.output_filter_config
    common = dict(
        sample_rate=config.sample_rate,
        num_groups=config.num_groups,
        delays=config.delay_length_samps,
        coupling_matrix_type=fl_cfg.coupling_matrix_type,
        use_zero_coupling=fl_cfg.use_zero_coupling,
        coupling_matrix_order=fl_cfg.pu_matrix_order,
        generator=torch.Generator().manual_seed(config.seed),
        **kw,
    )
    if variant == "single_pos":
        in_cfg = config.input_filter_config
        return DiffGFDNSinglePos(
            use_svf_in_output=out_cfg.use_svfs,
            use_svf_in_input=False if in_cfg is None else in_cfg.use_svfs,
            compress_pole_factor=out_cfg.compress_pole_factor,
            **common,
        ).to(dev)
    common.update(
        num_fourier_features=out_cfg.num_fourier_features,
        num_hidden_layers=out_cfg.num_hidden_layers,
        num_neurons=out_cfg.num_neurons_per_layer,
    )
    if variant == "directional":
        if desired_directions is None:
            raise ValueError("the directional variant needs the dataset's desired_directions")
        model = DiffDirectionalFDNVarReceiverPos(
            ambi_order=config.ambi_order,
            use_skip_connections=out_cfg.use_skip_connections,
            analysis_matrix=build_analysis_matrix(
                config.ambi_order, desired_directions, out_cfg.beamformer_type
            ),
            **common,
        )
    elif variant == "var_source_receiver":
        in_cfg = config.input_filter_config or out_cfg
        model = DiffGFDNVarSourceReceiverPos(
            use_svf_in_output=out_cfg.use_svfs,
            use_svf_in_input=in_cfg.use_svfs,
            encoding_type=out_cfg.encoding_type,
            compress_pole_factor=out_cfg.compress_pole_factor,
            input_num_fourier_features=in_cfg.num_fourier_features,
            input_num_hidden_layers=in_cfg.num_hidden_layers,
            input_num_neurons=in_cfg.num_neurons_per_layer,
            **common,
        )
    else:
        model = DiffGFDNVarReceiverPos(
            use_svf_in_output=out_cfg.use_svfs,
            encoding_type=out_cfg.encoding_type,
            compress_pole_factor=out_cfg.compress_pole_factor,
            **common,
        )
    return model.to(dev)


def build_colorless_fdn(
    config: DiffGFDNConfig, group_idx: int, device: Union[str, torch.device] = "cuda"
) -> ColorlessFDN:
    """The lossless prototype FDN over one group's delay lines on ``device``,
    parameters drawn from a ``torch.Generator`` seeded with ``config.seed +
    group_idx``."""
    delays = np.asarray(config.delay_length_samps)
    nper = len(delays) // config.num_groups
    model = ColorlessFDN(
        sample_rate=config.sample_rate,
        delays=delays[group_idx * nper:(group_idx + 1) * nper],
        generator=torch.Generator().manual_seed(config.seed + group_idx),
    )
    return model.to(resolve_device(device))
