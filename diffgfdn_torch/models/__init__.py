"""GFDN models: MLP heads, the feedback loop, DiffGFDNVarReceiverPos and the
directional DiffDirectionalFDNVarReceiverPos."""

from .feedback_loop import FeedbackLoop
from .gfdn import DiffDirectionalFDNVarReceiverPos, DiffGFDN, DiffGFDNVarReceiverPos

__all__ = ["DiffDirectionalFDNVarReceiverPos", "DiffGFDN", "DiffGFDNVarReceiverPos", "FeedbackLoop"]
