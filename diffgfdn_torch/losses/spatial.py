"""Spatial-sampling helpers of the directional losses (port of ``losses/spatial.py``, subset).

Only :func:`make_decay_envelopes` is ported: the directional EDC loss compares
the model's directional EDCs with these envelopes weighted by the
common-slope amplitudes. The common-slopes losses wait for ROADMAP A12.
"""

import numpy as np
import torch

from ..ops.basic import decay_kernel


def make_decay_envelopes(
    common_decay_times: np.ndarray, edc_len_samps: int, fs: float
) -> torch.Tensor:
    """(num_slopes, T) unit-norm decay kernels, float32, on the host."""
    t_axis = np.arange(edc_len_samps) / fs
    env = decay_kernel(np.asarray(common_decay_times).reshape(-1), t_axis,
                       normalize_envelope=True)
    return torch.from_numpy(np.ascontiguousarray(env.T, dtype=np.float32))
