"""Model construction from a config and dataset metadata (port of ``training/build.py``).

Host-side: fits the absorption filters (GEQ) or gains once, then builds a
:class:`DiffGFDNVarReceiverPos` (``variant="var_receiver"``) or a
:class:`DiffDirectionalFDNVarReceiverPos` (``variant="directional"``, with
the analysis matrix designed for the dataset's directions) with parameters
drawn from a seeded ``torch.Generator``, and moves it to the device.
"""

from typing import Optional, Union

import numpy as np
import torch

from ..config.schema import CouplingMatrixType, DiffGFDNConfig
from ..models import DiffDirectionalFDNVarReceiverPos, DiffGFDNVarReceiverPos
from ..models.spatial import build_analysis_matrix
from ..ops.absorption import (
    decay_times_to_gain_filters_geq,
    decay_times_to_gain_per_sample,
)
from ..utils.device import resolve_device


def absorption_arrays(
    config: DiffGFDNConfig,
    common_decay_times: Optional[np.ndarray],
    band_centre_hz: Optional[np.ndarray],
) -> dict:
    """Resolve the absorption configuration -> ``gains`` or ``sos_coeffs``.

    ``common_decay_times``: (num_bands, num_groups) for GEQ filters, or
    (num_groups,) broadband for per-line gains.
    """
    dcfg = config.decay_filter_config
    if common_decay_times is None or dcfg.learn_common_decay_times:
        raise NotImplementedError(
            "learnable common decay times are not ported yet (ROADMAP A7)"
        )
    delays = np.asarray(config.delay_length_samps)
    nper = len(delays) // config.num_groups
    kw = dict(gains=None, sos_coeffs=None)
    # keep the band axis even for single-group configs
    cdt = np.asarray(common_decay_times)
    if not (cdt.ndim == 2 and cdt.shape[0] > 1 and cdt.shape[1] == config.num_groups):
        cdt = np.squeeze(cdt)
    if dcfg.use_absorption_filters and cdt.ndim == 2:
        per_group = [
            decay_times_to_gain_filters_geq(
                band_centre_hz, cdt[:, g], delays[g * nper : (g + 1) * nper],
                config.sample_rate,
            )
            for g in range(config.num_groups)
        ]
        kw["sos_coeffs"] = np.concatenate(per_group, axis=0)
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
) -> Union[DiffGFDNVarReceiverPos, DiffDirectionalFDNVarReceiverPos]:
    """Build the configured model on ``device``, parameters drawn from a
    ``torch.Generator`` seeded with ``config.seed``. The directional variant
    needs ``desired_directions`` (2, J), the dataset's (azimuth, elevation).

    Raises NotImplementedError, naming the ROADMAP item, for what is not
    ported yet.
    """
    dev = resolve_device(device)
    if variant not in ("var_receiver", "directional"):
        raise NotImplementedError(f"model variant {variant!r} is not ported yet (ROADMAP A10)")
    if config.colorless_fdn_config.use_colorless_prototype:
        raise NotImplementedError(
            "use_colorless_prototype (colorless warm start) is not ported yet (ROADMAP A10)"
        )
    fl_cfg = config.feedback_loop_config
    if fl_cfg.coupling_matrix_type is not CouplingMatrixType.SCALAR:
        raise NotImplementedError(
            f"coupling_matrix_type={fl_cfg.coupling_matrix_type.value} is not ported "
            "yet (ROADMAP A4)"
        )
    kw = absorption_arrays(config, common_decay_times, band_centre_hz)
    out_cfg = config.output_filter_config
    common = dict(
        sample_rate=config.sample_rate,
        num_groups=config.num_groups,
        delays=config.delay_length_samps,
        coupling_matrix_type=fl_cfg.coupling_matrix_type,
        use_zero_coupling=fl_cfg.use_zero_coupling,
        num_fourier_features=out_cfg.num_fourier_features,
        num_hidden_layers=out_cfg.num_hidden_layers,
        num_neurons=out_cfg.num_neurons_per_layer,
        generator=torch.Generator().manual_seed(config.seed),
        **kw,
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
    else:
        model = DiffGFDNVarReceiverPos(
            use_svf_in_output=out_cfg.use_svfs,
            encoding_type=out_cfg.encoding_type,
            compress_pole_factor=out_cfg.compress_pole_factor,
            **common,
        )
    return model.to(dev)
