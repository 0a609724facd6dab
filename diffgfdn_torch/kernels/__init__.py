"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``cinv``  — batched complex Gauss-Jordan inverse and its backward
  -P^H G P^H (``csrc/cinv.cu``);
* ``sos``   — fused biquad-cascade response and its coefficient gradients
  (``csrc/sos.cu``);
* ``lu``    — batched pivoted-LU single-RHS solve and the conjugate-transposed
  solve from its factors (``csrc/lu.cu``);
* ``decay`` — the EDC and EDR losses with their energy-decay integrals,
  forward and backward (``csrc/decay.cu``);
* ``linalg`` — the batch-shape front ends ``cinv`` and ``csolve1`` as
  autograd functions, and ``csolve`` (``cinv(M) @ B``), exported here as
  the JAX package's ``kernels`` exports it (its ``cinv`` stays
  ``linalg.cinv``: here ``kernels.cinv`` is the kernel's module).

Kernels build with ``nvcc`` at first use (``_build``); nothing is compiled
or loaded when a module is imported.
"""

from .linalg import csolve

__all__ = ["counted_wrappers", "csolve"]


def counted_wrappers() -> dict:
    """{name: wrapper} of every kernel wrapper that counts its launches in
    ``wrapper.launches``, looked up anew on each call (so that a wrapper a
    caller replaced is the one counted)."""
    from . import cinv, decay, lu, sos, tdgfdn

    return {
        "cinv": cinv.cinv,
        "neg_ptgpt": cinv.neg_ptgpt,
        "sos": sos.sos_cascade_response,
        "sos_backward": sos.sos_cascade_backward,
        "lu": lu.lu_solve,
        "lut_apply": lu.lut_apply,
        "tdgfdn": tdgfdn.delay_line_outputs,
        "edc_loss": decay.edc_loss_forward,
        "edc_loss_backward": decay.edc_loss_backward,
        "edr_loss": decay.edr_loss_forward,
        "edr_loss_backward": decay.edr_loss_backward,
    }
