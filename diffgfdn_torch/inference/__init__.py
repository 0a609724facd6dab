"""Serving: RIRs from a checkpoint at dataset receiver positions, broadband
RIRs (and directional SRIRs) from subband models, alias-free time-domain synthesis, SRIRs from
common-slopes spatial-sampling models, 6DoF binaural rendering, SRIR-to-BRIR conversion and SOFA
file I/O."""

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
from .rendering import (
    add_direct_and_early_path,
    BinauralDynamicRendering,
    DynamicRenderingMovingReceiver,
    fade_windows,
    integrated_loudness,
    normalise_loudness,
)
from .sofa import convert_srir_to_brir, HRIRSOFAReader, SRIRSOFAWriter
from .spatial_inference import (
    get_ambisonic_rirs,
    get_output_from_trained_model,
    get_soundfield_from_trained_model,
)

__all__ = [
    "BinauralDynamicRendering",
    "DynamicRenderingMovingReceiver",
    "HRIRSOFAReader",
    "InferDiffGFDN",
    "SRIRSOFAWriter",
    "add_direct_and_early_path",
    "band_reconstruction_filters",
    "broadband_edc_errors_device",
    "convert_srir_to_brir",
    "fade_windows",
    "get_ambisonic_rirs",
    "get_output_from_trained_model",
    "get_soundfield_from_trained_model",
    "infer_all_octave_bands",
    "infer_all_octave_bands_directional",
    "integrated_loudness",
    "make_rir_synthesis_fn",
    "make_time_domain_synthesis_fn",
    "merge_subband_rirs",
    "normalise_loudness",
    "subband_energy_compensation",
]
