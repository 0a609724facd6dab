"""Serving: RIRs from a checkpoint at dataset receiver positions, broadband
RIRs from subband models, and alias-free time-domain synthesis."""

from .gfdn_inference import (
    band_reconstruction_filters,
    broadband_edc_errors_device,
    infer_all_octave_bands,
    InferDiffGFDN,
    make_rir_synthesis_fn,
    make_time_domain_synthesis_fn,
    merge_subband_rirs,
    subband_energy_compensation,
)

__all__ = [
    "InferDiffGFDN",
    "band_reconstruction_filters",
    "broadband_edc_errors_device",
    "infer_all_octave_bands",
    "make_rir_synthesis_fn",
    "make_time_domain_synthesis_fn",
    "merge_subband_rirs",
    "subband_energy_compensation",
]
