"""Analytical FLOP cost models for GFDN deployment comparisons.

Mirrors the reference's ``notebooks/compare_flops.ipynb`` cost models
(the only quantitative anchors the reference publishes — see BASELINE.md):

* a single full-band GFDN with frequency-dependent (order-2B GEQ)
  absorption costs ``2N^2 + N + 27NB + 1`` FLOPs/sample;
* B parallel subband GFDNs with scalar absorption cost
  ``B (2N^2 + 4N + 1)`` FLOPs/sample;
* an MLP forward costs ``L (2n^2 + n) + F_in (2n + 1)`` FLOPs;
* a directional GFDN adds SH-weight mixing per ambisonic channel, compared
  against partitioned convolution of J-channel SRIRs.

These are per-sample serial-renderer costs (the deployment question:
"can this run in an audio callback?"), not training costs. Pure
arithmetic: a copy of the JAX package's ``utils/flops.py``.
"""

import numpy as np

from ..ops.basic import ms_to_samps


def gfdn_flops(
    num_delay_lines: int,
    num_bands: int = 8,
    is_parallel: bool = False,
) -> int:
    """FLOPs/sample of a GFDN renderer.

    ``is_parallel=False``: ONE full-band GFDN of N delay lines whose
    absorption filters are GEQ cascades over ``num_bands`` octave bands
    (biquad cascade of 2B+... sections -> 27*N*B term). ``is_parallel=True``:
    ``num_bands`` independent subband GFDNs with scalar absorption.
    Reference: compare_flops.ipynb ``gfdn_flops``.
    """
    n, b = num_delay_lines, num_bands
    if is_parallel:
        return b * (2 * n * n + 4 * n + 1)
    return 2 * n * n + n + 27 * n * b + 1


def mlp_flops(
    num_hidden_layers: int, num_neurons: int, num_input_features: int
) -> int:
    """FLOPs of one MLP forward (reference: compare_flops.ipynb ``mlp_flops``)."""
    length, n, f_in = num_hidden_layers, num_neurons, num_input_features
    return length * (2 * n * n + n) + f_in * (2 * n + 1)


def dir_gfdn_flops(
    ambi_order: int = 2,
    num_groups: int = 3,
    num_bands: int = 8,
    num_directions: int = 12,
) -> int:
    """FLOPs/sample of a directional (SH-domain) grouped FDN renderer.

    Each group drives (ambi_order+1)^2 delay lines; the SH outputs are
    beamformed to ``num_directions`` directions per band.
    Reference: compare_flops.ipynb ``dir_gfdn_flops``.
    """
    n_sh = (ambi_order + 1) ** 2
    n = num_groups * n_sh
    core = gfdn_flops(n, num_bands, is_parallel=True)
    mixing = num_bands * num_directions * (2 * n_sh + 1)
    return core + mixing


def conv_flops(
    num_channels: int,
    rir_len_ms: float,
    fft_size: int = 512,
    sample_rate: float = 48000.0,
) -> float:
    """FLOPs/sample of partitioned (overlap-save) convolution of J-channel RIRs.

    Standard uniform-partition cost: one rFFT + irFFT per block plus a
    complex multiply-accumulate over all partitions per channel.
    Reference: compare_flops.ipynb ``conv_flops``.
    """
    block = fft_size // 2
    nfft = fft_size
    rir_len = int(rir_len_ms * 1e-3 * sample_rate)
    num_parts = int(np.ceil(rir_len / block))
    fft_cost = 2.5 * nfft * np.log2(nfft)  # rfft + irfft amortized
    cmul = 4.0 * (nfft // 2 + 1) * num_parts  # complex MAC per partition
    per_block = fft_cost + num_channels * (cmul + fft_cost)
    return per_block / block


def mlp_mems(
    num_hidden_layers: int, num_neurons: int, num_input_features: int
) -> int:
    """Parameter-memory footprint of the MLP (compare_flops.ipynb ``mlp_mems``)."""
    length, n, f_in = num_hidden_layers, num_neurons, num_input_features
    return length * (n * n + n) + f_in * (n + 1)


def gfdn_mems(
    sample_rate: float,
    num_delay_lines: int,
    avg_delay_ms: float,
    num_groups: int,
) -> int:
    """State-memory footprint of a grouped FDN: delay-line storage plus
    ONE group's mixing matrix, io gains, and group state — reproducing the
    reference's cost model verbatim (compare_flops.ipynb ``gfdn_mems``),
    which counts (N/G)^2 matrix elements for a single group only."""
    matrix_elems = (num_delay_lines // num_groups) ** 2
    num_modes = ms_to_samps(avg_delay_ms, sample_rate) * num_delay_lines
    return num_modes + matrix_elems + 2 * num_delay_lines + 3 * num_groups
