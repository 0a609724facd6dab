"""Which implementation a kernel wrapper runs, decided by its tensors.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor takes
the hand-written kernel, or the wrapper raises. No wrapper falls back from
one to the other. The only way to run a plain version on CUDA tensors is to
ask for it explicitly with :func:`plain_versions`, which the comparison runs
of ``chip_smoke.py`` and the CUDA tests use to hold each kernel against its
plain version on the same device. Under ``torch.func.vmap``, the autograd
functions fold the vmap axis into the system axis (:func:`fold_vmap_axis`),
so a wrapper sees every vmapped slice in one call.
"""

import contextlib
from typing import Iterator

import torch

_plain_on_card = False


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Within the block, wrappers run their plain versions on CUDA tensors too."""
    global _plain_on_card
    previous = _plain_on_card
    _plain_on_card = True
    try:
        yield
    finally:
        _plain_on_card = previous


def plain_on_card() -> bool:
    """True within a :func:`plain_versions` block."""
    return _plain_on_card


def runs_kernel(*tensors: torch.Tensor) -> bool:
    """True when the wrapper must launch its kernel for these tensors.

    Raises for tensors on different devices or on a device that has neither
    a kernel nor a plain version here.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on different devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return not _plain_on_card
    raise ValueError(f"no kernel for device {device}")


def fold_vmap_axis(x: torch.Tensor, bdim, batch_size: int) -> torch.Tensor:
    """An input of an autograd function's ``vmap`` rule with its vmap axis
    (``bdim``) moved first and folded into the leading (system) axis, so that
    one launch serves every vmapped slice; an input without a vmap axis
    (``bdim`` None) is repeated over it."""
    x = x.expand(batch_size, *x.shape) if bdim is None else x.movedim(bdim, 0)
    return x.reshape(-1, *x.shape[2:]).contiguous()
