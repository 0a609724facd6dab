"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``cinv``  — batched complex Gauss-Jordan inverse (``csrc/cinv.cu``);
* ``sos``   — fused biquad-cascade response (``csrc/sos.cu``);
* ``lu``    — batched pivoted-LU single-RHS solve (``csrc/lu.cu``).

Kernels build with ``nvcc`` at first use (``_build``); nothing is compiled
or loaded when a module is imported.
"""
