"""Serving: RIRs from a checkpoint at dataset receiver positions."""

from .gfdn_inference import InferDiffGFDN, make_rir_synthesis_fn

__all__ = ["InferDiffGFDN", "make_rir_synthesis_fn"]
