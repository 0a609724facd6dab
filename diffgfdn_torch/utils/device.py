"""Device resolution for the port's entry points."""

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for the CPU.

    Raises when CUDA is asked for and no card is present (there is no silent
    CPU fallback). Turns TF32 off for matrix products and convolutions: the
    JAX package pins full f32 (``Precision.HIGHEST``) on every contraction
    the results depend on.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
