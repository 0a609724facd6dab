"""The README's end-to-end walkthrough and the notebook studies, on the port.

One module per study of the repository's ``examples/``, under the same name
and with the same public functions, run as

    python -m diffgfdn_torch.examples.<name> [--device cpu]

Each entry point that computes on a device runs on CUDA unless the caller
passes ``device="cpu"`` (``--device cpu``). Each study splits its numbers
from its figures: a compute function returns the numbers the study's
conclusion is drawn from, a drawing function (matplotlib, imported only
when it draws) writes the same files as the JAX package's study, and
``run`` / ``main`` call both.
"""
