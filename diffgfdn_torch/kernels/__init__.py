"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``cinv``  — batched complex Gauss-Jordan inverse and its backward
  -P^H G P^H (``csrc/cinv.cu``);
* ``sos``   — fused biquad-cascade response and its coefficient gradients
  (``csrc/sos.cu``);
* ``lu``    — batched pivoted-LU single-RHS solve and the conjugate-transposed
  solve from its factors (``csrc/lu.cu``);
* ``linalg`` — the batch-shape front ends ``cinv`` and ``csolve1`` as
  autograd functions.

Kernels build with ``nvcc`` at first use (``_build``); nothing is compiled
or loaded when a module is imported.
"""
