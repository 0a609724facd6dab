"""Fused biquad-cascade response and its backward: the kernels and their plain versions.

* the forward replaces ``diffgfdn_tpu/kernels/pallas_sos.py::_fwd_kernel``;
  :func:`sos_cascade_plain` is the same arithmetic as PyTorch tensor
  operations (re/im planes, each section as P conj(Q) / |Q|^2);
* :func:`sos_cascade_backward` replaces ``pallas_sos.py::_bwd_kernel``: the
  coefficient gradients in torch's complex gradient convention, reduced over
  the bins; :func:`sos_cascade_backward_plain` is its plain version.

Both kernels are in ``csrc/sos.cu``. They agree with their plain versions
within a tolerance, not bit for bit: they evaluate the section polynomials
as the plain versions do, but fuse the products after them, and the forward
takes one reciprocal per output (prod P_k and prod Q_k carried through the
sections) where the plain version divides per section (1e-4 of max |h| on
the model's inputs; the backward's sums also run in another order, and its
reciprocals are the card's one-instruction approximation). :func:`sos_cascade_response` is an autograd function whose forward
saves the response h with the coefficients and w, when a coefficient needs
a gradient, and whose backward reads that h instead of recomputing it as
the JAX custom VJP does. The plain versions work in float64 / complex128
too (for ``torch.autograd.gradcheck``); the kernels take float32 /
complex64.
"""

import ctypes
import math
from typing import Callable, Tuple

import torch

from . import _build
from .dispatch import fold_vmap_axis, runs_kernel

MAX_SECTIONS = 16  # the backward kernel's template instantiations
BWD_THREADS = 256  # kThreads of csrc/sos.cu
BWD_SPLIT = 2  # kSplit of csrc/sos.cu: the warps that share a bin's sections
# bins per thread of the backward: 33 blocks per row at F = 65537, 3168 blocks
# over 96 rows, six waves on 132 SMs at four blocks per SM
BWD_BINS_PER_THREAD = 16
_TINY = 1e-30  # clamp of |P|^2 and |Q|^2 in the backward, as in _bwd_kernel
_SIGNATURES = {
    "diffgfdn_sos_cascade_c64": [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    "diffgfdn_sos_cascade_bwd_c64": [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}


def _poly(c: torch.Tensor, zre, zim, z2re, z2im):
    """c0 + c1 w + c2 w^2 for coefficient rows c (R, 3) -> (R, F) re/im."""
    c0, c1, c2 = c[:, 0:1], c[:, 1:2], c[:, 2:3]
    return c0 + c1 * zre + c2 * z2re, c1 * zim + c2 * z2im


def sos_cascade_plain(num: torch.Tensor, den: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (R, K, 3) x2 real, w (F,) complex -> (R, F).

    h[r, f] = prod_k P_k(w_f) / Q_k(w_f), P and Q quadratics in w.
    """
    zre, zim = w.real[None], w.imag[None]  # (1, F)
    z2re = zre * zre - zim * zim
    z2im = 2.0 * zre * zim
    r = num.shape[0]
    hre = torch.ones((r, w.shape[0]), dtype=w.real.dtype, device=w.device)
    him = torch.zeros_like(hre)
    for i in range(num.shape[1]):
        pre, pim = _poly(num[:, i], zre, zim, z2re, z2im)
        qre, qim = _poly(den[:, i], zre, zim, z2re, z2im)
        inv = 1.0 / (qre * qre + qim * qim)
        sre = (pre * qre + pim * qim) * inv
        sim = (pim * qre - pre * qim) * inv
        hre, him = hre * sre - him * sim, hre * sim + him * sre
    return torch.complex(hre, him)


def sos_cascade(num: torch.Tensor, den: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cascade response at w: (R, K, 3) float32 x2, w (F,) complex64 -> (R, F).

    CPU tensors take :func:`sos_cascade_plain`; CUDA tensors launch
    ``csrc/sos.cu``, counted in ``sos_cascade_response.launches``.
    """
    if not runs_kernel(num, den, w):
        return sos_cascade_plain(num, den, w)
    r, k, _ = num.shape
    w = w.contiguous()
    h = torch.empty((r, w.shape[0]), dtype=torch.complex64, device=w.device)
    lib = _build.load("sos", _SIGNATURES)
    with torch.cuda.device(w.device):
        err = lib.diffgfdn_sos_cascade_c64(
            num.data_ptr(), den.data_ptr(), w.data_ptr(), h.data_ptr(),
            r, k, w.shape[0], torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sos_cascade_response")
    sos_cascade_response.launches += 1
    return h


def sos_cascade_backward_plain(
    num: torch.Tensor, den: torch.Tensor, w: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the cascade's backward -> (dnum, dden) (R, K, 3).

    For the gradient G (R, F) of a real loss with respect to the response
    h (R, F) at w: dnum[r, k, j] = sum_f Re[conj(G) h w^j / P_k] and
    dden[r, k, j] = -sum_f Re[conj(G) h w^j / Q_k], |P|^2 and |Q|^2 clamped
    at 1e-30. h is the forward's output: the JAX kernel recomputes it with
    |Q|^2 clamped too, which gives the same h wherever |Q_k|^2 >= 1e-30 for
    every k, that is wherever h is finite.
    """
    zre, zim = w.real[None], w.imag[None]
    z2re = zre * zre - zim * zim
    z2im = 2.0 * zre * zim
    k = num.shape[1]
    # s = conj(G) h
    gre, gim = g.real, g.imag
    hre, him = h.real, h.imag
    sre = gre * hre + gim * him
    sim = gre * him - gim * hre
    dnum = torch.empty_like(num)
    dden = torch.empty_like(den)
    for i in range(k):
        pre, pim = _poly(num[:, i], zre, zim, z2re, z2im)
        qre, qim = _poly(den[:, i], zre, zim, z2re, z2im)
        ip = 1.0 / torch.clamp(pre * pre + pim * pim, min=_TINY)
        iq = 1.0 / torch.clamp(qre * qre + qim * qim, min=_TINY)
        tre = (sre * pre + sim * pim) * ip  # t = s / P
        tim = (sim * pre - sre * pim) * ip
        ure = (sre * qre + sim * qim) * iq  # u = s / Q
        uim = (sim * qre - sre * qim) * iq
        dnum[:, i, 0] = torch.sum(tre, dim=1)
        dnum[:, i, 1] = torch.sum(tre * zre - tim * zim, dim=1)
        dnum[:, i, 2] = torch.sum(tre * z2re - tim * z2im, dim=1)
        dden[:, i, 0] = -torch.sum(ure, dim=1)
        dden[:, i, 1] = -torch.sum(ure * zre - uim * zim, dim=1)
        dden[:, i, 2] = -torch.sum(ure * z2re - uim * z2im, dim=1)
    return dnum, dden


def sos_cascade_backward(
    num: torch.Tensor, den: torch.Tensor, w: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coefficient gradients of the cascade: (R, K, 3) float32 x2, w (F,),
    g and the forward's response h (R, F) complex64 -> (dnum, dden) (R, K, 3)
    float32.

    CPU tensors take :func:`sos_cascade_backward_plain`; CUDA tensors launch
    the two-pass reduction of ``csrc/sos.cu`` (K <= 16, contiguous inputs),
    counted in ``sos_cascade_backward.launches``.
    """
    r, k, _ = num.shape
    for name, t in (("g", g), ("h", h)):
        if tuple(t.shape) != (r, w.shape[0]):
            raise ValueError(
                f"sos_cascade_backward: {name} {tuple(t.shape)} for R={r}, F={w.shape[0]}"
            )
    if not runs_kernel(num, den, w, g, h):
        return sos_cascade_backward_plain(num, den, w, g, h)
    if (k > MAX_SECTIONS or num.dtype != torch.float32 or g.dtype != torch.complex64
            or h.dtype != torch.complex64
            or not all(t.is_contiguous() for t in (num, den, w, g, h))):
        raise ValueError(
            f"sos_cascade_backward kernel takes contiguous float32 / complex64 inputs "
            f"with K <= {MAX_SECTIONS}"
        )
    f = w.shape[0]
    n_blocks = -(-f // (BWD_THREADS // BWD_SPLIT * BWD_BINS_PER_THREAD))
    partial = torch.empty((n_blocks, r, 6 * k), dtype=torch.float32, device=g.device)
    dnum = torch.empty_like(num)
    dden = torch.empty_like(den)
    lib = _build.load("sos", _SIGNATURES)
    with torch.cuda.device(g.device):
        err = lib.diffgfdn_sos_cascade_bwd_c64(
            num.data_ptr(), den.data_ptr(), w.data_ptr(), g.data_ptr(), h.data_ptr(),
            partial.data_ptr(), dnum.data_ptr(), dden.data_ptr(), r, k, f, n_blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sos_cascade_backward")
    sos_cascade_backward.launches += 1
    return dnum, dden


sos_cascade_backward.launches = 0


class _Cascade(torch.autograd.Function):
    """h = cascade(num, den, w) with the analytic coefficient backward.

    Saves num, den, w and the response h, which the backward reads (the
    autograd version counter raises if a caller wrote into h in place), and
    nothing when neither coefficient set needs a gradient. No gradient flows
    to w. Under ``torch.func.vmap`` the vmap axis of the coefficients is
    folded into R, so that one launch serves every vmapped cascade (the band
    axis of the band-parallel trainer); w takes no vmap axis.
    """

    @staticmethod
    def forward(num, den, w, response: Callable, backward: Callable):
        return response(num, den, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        num, den, w, _, backward = inputs
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(num, den, w, output)
            ctx.backward_fn = backward

    @staticmethod
    def backward(ctx, g):
        need_num, need_den = ctx.needs_input_grad[:2]
        if not (need_num or need_den):
            return None, None, None, None, None
        num, den, w, h = ctx.saved_tensors
        dnum, dden = ctx.backward_fn(num, den, w, g.contiguous(), h)
        return (dnum if need_num else None), (dden if need_den else None), None, None, None

    @staticmethod
    def vmap(info, in_dims, num, den, w, response, backward):
        if in_dims[2] is not None:
            raise ValueError("sos_cascade_response: z (w) cannot carry a vmap axis")
        n = info.batch_size
        h = _Cascade.apply(fold_vmap_axis(num, in_dims[0], n),
                           fold_vmap_axis(den, in_dims[1], n), w, response, backward)
        return h.reshape(n, -1, h.shape[-1]), 0


def cascade_with(
    num: torch.Tensor, den: torch.Tensor, w: torch.Tensor, response: Callable,
    backward: Callable,
) -> torch.Tensor:
    """Differentiable cascade response at w for (R, K, 3) coefficients through
    the given forward and backward implementations (the tests pass the plain
    versions in float64)."""
    return _Cascade.apply(num, den, w, response, backward)


def sos_cascade_response(num: torch.Tensor, den: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Cascade response: (..., K, 3) x2 real coefficients, z (F,) -> (..., F) complex64.

    The polynomials are in z^-1, so the cascade is evaluated at
    w = (1/z) as complex64. Differentiable in the coefficients (backward:
    :func:`sos_cascade_backward`). CPU tensors take the plain versions; CUDA
    tensors launch ``csrc/sos.cu``, the forward counted in
    ``sos_cascade_response.launches``.
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
    return cascade_with(num_r, den_r, w, sos_cascade, sos_cascade_backward).reshape(
        *lead, z.shape[0]
    )


sos_cascade_response.launches = 0
