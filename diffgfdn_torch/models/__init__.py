"""GFDN models: MLP heads, the feedback loop and DiffGFDNVarReceiverPos."""

from .feedback_loop import FeedbackLoop
from .gfdn import DiffGFDN, DiffGFDNVarReceiverPos

__all__ = ["DiffGFDN", "DiffGFDNVarReceiverPos", "FeedbackLoop"]
