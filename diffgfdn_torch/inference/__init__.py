"""Serving: RIRs from a checkpoint at dataset receiver positions, and
alias-free time-domain synthesis."""

from .gfdn_inference import (
    InferDiffGFDN,
    make_rir_synthesis_fn,
    make_time_domain_synthesis_fn,
    merge_subband_rirs,
    subband_energy_compensation,
)

__all__ = [
    "InferDiffGFDN",
    "make_rir_synthesis_fn",
    "make_time_domain_synthesis_fn",
    "merge_subband_rirs",
    "subband_energy_compensation",
]
