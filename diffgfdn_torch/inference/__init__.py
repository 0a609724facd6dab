"""Serving: RIRs from a checkpoint at dataset receiver positions, broadband
RIRs (and directional SRIRs) from subband models, alias-free time-domain synthesis, and SRIRs from
common-slopes spatial-sampling models."""

from .gfdn_inference import (
    band_reconstruction_filters,
    broadband_edc_errors_device,
    infer_all_octave_bands,
    infer_all_octave_bands_directional,
    InferDiffGFDN,
    make_rir_synthesis_fn,
    make_time_domain_synthesis_fn,
    merge_subband_rirs,
    subband_energy_compensation,
)
from .spatial_inference import (
    get_ambisonic_rirs,
    get_output_from_trained_model,
    get_soundfield_from_trained_model,
)

__all__ = [
    "InferDiffGFDN",
    "band_reconstruction_filters",
    "broadband_edc_errors_device",
    "get_ambisonic_rirs",
    "get_output_from_trained_model",
    "get_soundfield_from_trained_model",
    "infer_all_octave_bands",
    "infer_all_octave_bands_directional",
    "make_rir_synthesis_fn",
    "make_time_domain_synthesis_fn",
    "merge_subband_rirs",
    "subband_energy_compensation",
]
