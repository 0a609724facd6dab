"""PyTorch / CUDA port of diffgfdn_tpu for NVIDIA Hopper (H100).

Serving slice: ``inference.InferDiffGFDN`` reads a JAX-format checkpoint and
returns RIRs at dataset receiver positions through the hand-written kernels
in ``kernels/`` (``csrc/*.cu``). Entry points run on CUDA unless the caller
passes ``device="cpu"``, where each kernel wrapper takes its plain PyTorch
version. The package never imports JAX or ``diffgfdn_tpu``.
"""
