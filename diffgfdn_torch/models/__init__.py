"""GFDN models: MLP heads, the feedback loop, DiffGFDNVarReceiverPos, the
source-and-receiver DiffGFDNVarSourceReceiverPos, the single-position
DiffGFDNSinglePos, the directional
DiffDirectionalFDNVarReceiverPos and the colorless prototype ColorlessFDN."""

from .colorless import ColorlessFDN
from .feedback_loop import FeedbackLoop
from .gfdn import (
    DiffDirectionalFDNVarReceiverPos,
    DiffGFDN,
    DiffGFDNSinglePos,
    DiffGFDNVarReceiverPos,
    DiffGFDNVarSourceReceiverPos,
)

__all__ = ["ColorlessFDN", "DiffDirectionalFDNVarReceiverPos", "DiffGFDN",
           "DiffGFDNSinglePos", "DiffGFDNVarReceiverPos", "DiffGFDNVarSourceReceiverPos",
           "FeedbackLoop"]
