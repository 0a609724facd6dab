"""Fused biquad-cascade response: the kernel and its plain version.

Replaces ``diffgfdn_tpu/kernels/pallas_sos.py::_fwd_kernel``. The kernel is
``csrc/sos.cu``; :func:`sos_cascade_plain` is the same arithmetic as PyTorch
tensor operations (re/im planes, each section as P conj(Q) / |Q|^2).
"""

import ctypes
import math

import torch

from . import _build
from .dispatch import runs_kernel

_SIGNATURES = {
    "diffgfdn_sos_cascade_c64": [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
}


def sos_cascade_plain(num: torch.Tensor, den: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (R, K, 3) x2 float32, w (F,) complex64 -> (R, F).

    h[r, f] = prod_k P_k(w_f) / Q_k(w_f), P and Q quadratics in w.
    """
    zre, zim = w.real[None], w.imag[None]  # (1, F)
    z2re = zre * zre - zim * zim
    z2im = 2.0 * zre * zim
    r = num.shape[0]
    hre = torch.ones((r, w.shape[0]), dtype=torch.float32, device=w.device)
    him = torch.zeros_like(hre)
    for i in range(num.shape[1]):
        c0, c1, c2 = num[:, i, 0:1], num[:, i, 1:2], num[:, i, 2:3]
        d0, d1, d2 = den[:, i, 0:1], den[:, i, 1:2], den[:, i, 2:3]
        pre = c0 + c1 * zre + c2 * z2re
        pim = c1 * zim + c2 * z2im
        qre = d0 + d1 * zre + d2 * z2re
        qim = d1 * zim + d2 * z2im
        inv = 1.0 / (qre * qre + qim * qim)
        sre = (pre * qre + pim * qim) * inv
        sim = (pim * qre - pre * qim) * inv
        hre, him = hre * sre - him * sim, hre * sim + him * sre
    return torch.complex(hre, him)


def sos_cascade_response(num: torch.Tensor, den: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Cascade response: (..., K, 3) x2 real coefficients, z (F,) -> (..., F) complex64.

    The polynomials are in z^-1, so the cascade is evaluated at
    w = (1/z) as complex64. CPU tensors take :func:`sos_cascade_plain`; CUDA
    tensors launch ``csrc/sos.cu``, counted in ``sos_cascade_response.launches``.
    """
    if num.shape != den.shape or num.shape[-1] != 3 or z.dim() != 1:
        raise ValueError(
            f"sos_cascade_response takes (..., K, 3) coefficients and (F,) z, got "
            f"{tuple(num.shape)}, {tuple(den.shape)}, {tuple(z.shape)}"
        )
    lead, k = num.shape[:-2], num.shape[-2]
    r = math.prod(lead)
    num_r = num.reshape(r, k, 3).to(torch.float32).contiguous()
    den_r = den.reshape(r, k, 3).to(torch.float32).contiguous()
    w = (1.0 / z).to(torch.complex64)
    if not runs_kernel(num_r, den_r, w):
        return sos_cascade_plain(num_r, den_r, w).reshape(*lead, z.shape[0])
    w = w.contiguous()
    h = torch.empty((r, w.shape[0]), dtype=torch.complex64, device=w.device)
    lib = _build.load("sos", _SIGNATURES)
    with torch.cuda.device(w.device):
        err = lib.diffgfdn_sos_cascade_c64(
            num_r.data_ptr(), den_r.data_ptr(), w.data_ptr(), h.data_ptr(),
            r, k, w.shape[0], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sos_cascade_response")
    sos_cascade_response.launches += 1
    return h.reshape(*lead, z.shape[0])


sos_cascade_response.launches = 0
