"""The GFDN losses' energy decay, EDC (B8) and EDR (B9): the kernels and their plain versions.

Both losses integrate an energy from the end (the Schroeder integral
E(t) = sum_{u >= t} x(u)^2 of an RIR's window; the energy decay relief
E[f, m] = sum_{u >= m} |S[f, u]|^2 of its STFT), take
D = clamp(10 log10(|E| + eps), -200) and compare it with a precomputed
target in dB:

* :func:`edc_loss_forward` -- the mean |target - D| over rows of T samples
  (x (R, T), read at its row stride: a window of the irfft output, no slice
  copied), or with a 0/1 time mask sum(|target - D| mask) /
  (sum(mask) items + 1e-9);
* :func:`edr_loss_forward` -- per item the sum over bins (or ERB bands) and
  frames of |target - D|, each bin's sum weighted, over the item's target
  |.| sum, summed over the items; the input is the STFT as ``torch.fft.rfft``
  wrote it ((B, frames, bins) complex, seen through a transpose) or the
  ERB-grouped magnitudes (B, bands, frames) real.

Rows come in slices of ``items`` rows, each slice a loss of its own (one
slice, unless ``torch.func.vmap`` folded its axis into the rows). Each
forward also returns the local derivative h = dloss/dE without the loss's
outer factor (empty when no gradient is wanted); the backwards
(:func:`edc_loss_backward`, :func:`edr_loss_backward`) integrate
coef * h forward in time and multiply by 2 x (2 S for the complex STFT), in
torch's complex gradient convention. The plain versions are the port's
earlier PyTorch code (flip, cumsum, flip) for the forward and the same
analytic backward; CPU tensors take them and CUDA tensors launch
``csrc/decay.cu`` (float32 / complex64), each wrapper counting its calls in
``.launches``. :func:`edc_window_loss` and :func:`edr_features_loss` are
the differentiable front ends that ``losses/gfdn.py`` calls.
"""

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ..ops.basic import db, schroeder_backward_int
from ..ops.stft import edr_from_stft
from . import _build
from .dispatch import fold_vmap_axis, runs_kernel

EPS_F32 = 1.1920928955078125e-07  # float32 eps: ops/basic.py db's offset
FLOOR_DB = -200.0
LN10 = math.log(10.0)
EDC_THREADS = 256  # kThreads of csrc/decay.cu: a chunk is EDC_THREADS * run samples
EDC_BLOCKS_PER_SM = 8  # the blocks a forward asks of each SM (8 x 256 threads fill one)
EDC_MAX_RUN = 16  # samples a thread at most (a chunk's shared memory: 16.5 KiB)
EDR_BINS = 128  # kBins of csrc/decay.cu: bins a block
_SIGNATURES = {
    "diffgfdn_edc_loss_fwd": [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "diffgfdn_edc_loss_bwd": [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "diffgfdn_edr_loss_fwd": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "diffgfdn_edr_loss_bwd": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}
_sm_counts: Dict[torch.device, int] = {}


def local_derivative(target: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """d|target - D(e)| / de: sgn(D - target) [the clamp passes] 10 / ((|e| + eps) ln 10)
    sgn(e), with sgn(0) = 0 and the clamp passing at -200 dB itself, as
    autograd differentiates ``ops/basic.py`` db."""
    y = torch.abs(e) + EPS_F32
    d = 10.0 * torch.log10(y)
    slope = (d >= FLOOR_DB).to(e.dtype) * (10.0 / (y * LN10))
    return torch.sign(torch.clamp(d, min=FLOOR_DB) - target) * slope * torch.sign(e)


def _fold_strided(x: torch.Tensor, bdim, batch_size: int) -> torch.Tensor:
    """As :func:`fold_vmap_axis`, but a view where the strides allow (the
    kernels read the RIR windows and the STFT at their strides)."""
    x = x.expand(batch_size, *x.shape) if bdim is None else x.movedim(bdim, 0)
    return x.reshape(-1, *x.shape[2:])


# ----------------------------------- EDC -----------------------------------


def edc_loss_plain(
    x: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor], items: int, save: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the EDC loss: x (R, T) rows, target (R, T)
    dB, mask (T,) or None -> (loss (R / items,), h (R, T) or empty, the
    normaliser (1,))."""
    e = schroeder_backward_int(x)
    err = torch.abs(target - db(e, is_squared=True))
    slices = x.shape[0] // items
    if mask is None:
        loss = torch.mean(err.reshape(slices, -1), dim=1)
        norm = torch.full((1,), float(items * x.shape[1]), dtype=x.dtype, device=x.device)
    else:
        norm = (torch.sum(mask) * items + 1e-9).reshape(1)
        loss = torch.sum((err * mask).reshape(slices, -1), dim=1) / norm
    h = torch.empty(0, dtype=x.dtype, device=x.device)
    if save:
        h = local_derivative(target, e)
        if mask is not None:
            h = mask * h
    return loss, h, norm


def edc_loss_backward_plain(
    x: torch.Tensor, h: torch.Tensor, norm: torch.Tensor, g: torch.Tensor, items: int
) -> torch.Tensor:
    """Plain PyTorch version of the EDC loss's backward: the gradient (R, T)
    of the slices' losses, given their gradients g (R / items,), with respect
    to the rows x: 2 x_u sum_{t <= u} (g / norm) h_t."""
    coef = torch.repeat_interleave(g / norm, items)[:, None]
    gp = torch.cumsum(coef * h, dim=-1)
    return 2.0 * (gp * x)


def _sm_count(device: torch.device) -> int:
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def edc_plan(rows: int, t_len: int, sms: int) -> Tuple[int, int]:
    """(samples a thread, chunks a row) of the EDC kernels: the fewest
    samples a thread (at most EDC_MAX_RUN) that leave about
    EDC_BLOCKS_PER_SM blocks for each of the card's ``sms`` SMs."""
    per_block = -(-rows * t_len // (EDC_BLOCKS_PER_SM * sms))
    run = min(EDC_MAX_RUN, max(1, -(-per_block // EDC_THREADS)))
    return run, -(-t_len // (EDC_THREADS * run))


def _edc_check(x: torch.Tensor, *floats: Optional[torch.Tensor]) -> None:
    if (x.dtype != torch.float32 or x.stride(-1) != 1 or x.shape[1] < 1 or x.shape[0] > 65535
            or any(t is not None and (t.dtype != torch.float32 or not t.is_contiguous())
                   for t in floats)):
        raise ValueError(
            "edc loss kernel takes float32 rows of at least one sample with unit stride (at "
            f"most 65535) and contiguous float32 operands; got x {x.dtype} {tuple(x.shape)} "
            f"strides {x.stride()}")


def edc_loss_forward(
    x: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor], items: int, save: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The EDC loss of :func:`edc_loss_plain`. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/decay.cu``'s three forward kernels,
    counted in ``edc_loss_forward.launches``."""
    operands = [x, target] + ([mask] if mask is not None else [])
    if not runs_kernel(*operands):
        return edc_loss_plain(x, target, mask, items, save)
    rows, t_len = x.shape
    _edc_check(x, target, mask)
    run, chunks = edc_plan(rows, t_len, _sm_count(x.device))
    scratch = torch.empty(2 * rows * chunks + chunks, dtype=torch.float32, device=x.device)
    h = torch.empty((rows, t_len) if save else (0,), dtype=torch.float32, device=x.device)
    loss = torch.empty(rows // items, dtype=torch.float32, device=x.device)
    norm = torch.empty(1, dtype=torch.float32, device=x.device)
    lib = _build.load("decay", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.diffgfdn_edc_loss_fwd(
            x.data_ptr(), x.stride(0), target.data_ptr(),
            None if mask is None else mask.data_ptr(), h.data_ptr() if save else None,
            scratch.data_ptr(), loss.data_ptr(), norm.data_ptr(), rows, t_len, items, chunks,
            run, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edc_loss_forward")
    edc_loss_forward.launches += 1
    return loss, h, norm


edc_loss_forward.launches = 0


def edc_loss_backward(
    x: torch.Tensor, h: torch.Tensor, norm: torch.Tensor, g: torch.Tensor, items: int
) -> torch.Tensor:
    """The backward of :func:`edc_loss_backward_plain`. CPU tensors take the
    plain version; CUDA tensors launch ``csrc/decay.cu``'s two backward
    kernels, counted in ``edc_loss_backward.launches``."""
    if not runs_kernel(x, h, norm, g):
        return edc_loss_backward_plain(x, h, norm, g, items)
    rows, t_len = x.shape
    _edc_check(x, h, norm, g)
    run, chunks = edc_plan(rows, t_len, _sm_count(x.device))
    scratch = torch.empty(rows * chunks, dtype=torch.float32, device=x.device)
    grad = torch.empty((rows, t_len), dtype=torch.float32, device=x.device)
    lib = _build.load("decay", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.diffgfdn_edc_loss_bwd(
            x.data_ptr(), x.stride(0), h.data_ptr(), g.data_ptr(), norm.data_ptr(),
            grad.data_ptr(), scratch.data_ptr(), rows, t_len, items, chunks, run,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edc_loss_backward")
    edc_loss_backward.launches += 1
    return grad


edc_loss_backward.launches = 0


class _EdcLoss(torch.autograd.Function):
    """(loss (R / items,), h, norm) of the EDC loss over rows x (R, T);
    differentiable in x alone (h and norm are not).

    Saves x, h and the normaliser when a gradient is wanted. Under
    ``torch.func.vmap`` the vmap axis of x and of the target is folded into
    the rows (x as a view where its strides allow), a slice of ``items`` rows
    each, so that one call serves every vmapped slice (the band axis of the
    band-parallel trainer); the mask takes no vmap axis.
    """

    @staticmethod
    def forward(x, target, mask, items, save):
        return edc_loss_forward(x, target, mask, items, save)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, _, items, save = inputs
        _, h, norm = output
        ctx.mark_non_differentiable(h, norm)
        ctx.set_materialize_grads(False)  # no zero gradients made for h and norm
        if save:
            ctx.save_for_backward(x, h, norm)
        ctx.items = items

    @staticmethod
    def backward(ctx, g, _h, _norm):
        if g is None or not ctx.needs_input_grad[0]:
            return (None,) * 5
        x, h, norm = ctx.saved_tensors
        return (edc_loss_backward(x, h, norm, g.contiguous(), ctx.items),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, target, mask, items, save):
        if in_dims[2] is not None:
            raise ValueError("edc loss: the time mask cannot carry a vmap axis")
        n = info.batch_size
        save = save or (torch.is_grad_enabled() and x.requires_grad)  # x: the physical tensor
        loss, h, norm = _EdcLoss.apply(
            _fold_strided(x, in_dims[0], n), fold_vmap_axis(target, in_dims[1], n), mask,
            items, save)
        if h.dim() == 2:
            return (loss.reshape(n, 1), h.reshape(n, -1, h.shape[-1]), norm), (0, 0, None)
        return (loss.reshape(n, 1), h, norm), (0, None, None)


def edc_window_loss(
    target: torch.Tensor, window: torch.Tensor, mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The EDC loss (a scalar) of RIR windows ``window`` (..., T) against the
    target EDC (..., T) in dB, with the optional (T,) time mask;
    differentiable in ``window``. A window cut from whole RIRs
    (``rir[..., start:end]``) is read in place, at its row stride."""
    t_len = window.shape[-1]
    if t_len < 1 or target.shape[-1] != t_len:
        raise ValueError(f"edc loss: windows of {t_len} samples, target EDC of "
                         f"{target.shape[-1]}")
    if target.requires_grad and torch.is_grad_enabled():
        raise ValueError("edc loss: the target EDC takes no gradient")
    x = window.reshape(-1, t_len)
    if x.stride(-1) != 1:
        x = x.contiguous()
    tgt = target.expand(window.shape).reshape(-1, t_len).contiguous()
    save = torch.is_grad_enabled() and window.requires_grad
    loss, _, _ = _EdcLoss.apply(x, tgt, mask, x.shape[0], save)
    return loss.reshape(())


# ----------------------------------- EDR -----------------------------------


def edr_loss_plain(
    s: torch.Tensor, target: torch.Tensor, abs_sum: torch.Tensor,
    weights: Optional[torch.Tensor], items: int, save: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the EDR loss: s (R, F, M) complex STFT or real
    ERB magnitudes, target (R, F, M) dB, abs_sum (R,), weights (F,) or None
    -> (loss (R / items,), h (R, M, F) frame-major, or empty)."""
    e = edr_from_stft(s, in_db=False)
    freq_loss = torch.sum(torch.abs(target - db(e, is_squared=True)), dim=-1)
    if weights is not None:
        freq_loss = freq_loss * weights
    loss = torch.sum((torch.sum(freq_loss, dim=-1) / abs_sum).reshape(-1, items), dim=1)
    h = torch.empty(0, dtype=abs_sum.dtype, device=s.device)
    if save:
        h = local_derivative(target, e)
        if weights is not None:
            h = weights[:, None] * h
        h = h.transpose(-1, -2).contiguous()
    return loss, h


def edr_loss_backward_plain(
    s: torch.Tensor, h: torch.Tensor, abs_sum: torch.Tensor, g: torch.Tensor, items: int
) -> torch.Tensor:
    """Plain PyTorch version of the EDR loss's backward: the gradient of the
    slices' losses (gradients g (R / items,)) with respect to s, in torch's
    convention: 2 s sum_{m' <= m} (g / abs_sum) h[m']."""
    coef = torch.repeat_interleave(g, items) / abs_sum
    gp = torch.cumsum(coef[:, None, None] * h, dim=1).transpose(-1, -2)
    if s.is_complex():
        return torch.complex(2.0 * (gp * s.real), 2.0 * (gp * s.imag))
    return 2.0 * (gp * s)


def _edr_check(s: torch.Tensor, *floats: Optional[torch.Tensor]) -> None:
    if (s.dtype not in (torch.float32, torch.complex64) or s.shape[0] > 65535
            or any(t is not None and (t.dtype != torch.float32 or not t.is_contiguous())
                   for t in floats)):
        raise ValueError(
            "edr loss kernel takes a float32 / complex64 input of at most 65535 rows and "
            f"contiguous float32 operands; got {s.dtype} {tuple(s.shape)}")


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def edr_loss_forward(
    s: torch.Tensor, target: torch.Tensor, abs_sum: torch.Tensor,
    weights: Optional[torch.Tensor], items: int, save: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The EDR loss of :func:`edr_loss_plain`. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/decay.cu``'s forward and final
    kernels (s read at its strides), counted in ``edr_loss_forward.launches``."""
    operands = [s, target, abs_sum] + ([weights] if weights is not None else [])
    if not runs_kernel(*operands):
        return edr_loss_plain(s, target, abs_sum, weights, items, save)
    _edr_check(s, target, abs_sum, weights)
    rows, bins, frames = s.shape
    tiles = -(-bins // EDR_BINS)
    scratch = torch.empty(rows * tiles, dtype=torch.float32, device=s.device)
    h = torch.empty((rows, frames, bins) if save else (0,), dtype=torch.float32,
                    device=s.device)
    loss = torch.empty(rows // items, dtype=torch.float32, device=s.device)
    lib = _build.load("decay", _SIGNATURES)
    with torch.cuda.device(s.device):
        err = lib.diffgfdn_edr_loss_fwd(
            s.data_ptr(), int(s.is_complex()), *_strides(s), target.data_ptr(),
            None if weights is None else weights.data_ptr(), h.data_ptr() if save else None,
            scratch.data_ptr(), abs_sum.data_ptr(), loss.data_ptr(), rows, bins, frames, items,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edr_loss_forward")
    edr_loss_forward.launches += 1
    return loss, h


edr_loss_forward.launches = 0


def edr_loss_backward(
    s: torch.Tensor, h: torch.Tensor, abs_sum: torch.Tensor, g: torch.Tensor, items: int
) -> torch.Tensor:
    """The backward of :func:`edr_loss_backward_plain`. CPU tensors take the
    plain version; CUDA tensors launch ``csrc/decay.cu``'s backward kernel,
    which writes the gradient at s's strides, counted in
    ``edr_loss_backward.launches``."""
    if not runs_kernel(s, h, abs_sum, g):
        return edr_loss_backward_plain(s, h, abs_sum, g, items)
    _edr_check(s, h, abs_sum, g)
    rows, bins, frames = s.shape
    grad = torch.empty_like(s)  # s's strides: rfft's layout under the transpose
    lib = _build.load("decay", _SIGNATURES)
    with torch.cuda.device(s.device):
        err = lib.diffgfdn_edr_loss_bwd(
            s.data_ptr(), int(s.is_complex()), *_strides(s), grad.data_ptr(), *_strides(grad),
            h.data_ptr(), g.data_ptr(), abs_sum.data_ptr(), rows, bins, frames, items,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edr_loss_backward")
    edr_loss_backward.launches += 1
    return grad


edr_loss_backward.launches = 0


class _EdrLoss(torch.autograd.Function):
    """(loss (R / items,), h) of the EDR loss; differentiable in s alone.

    Saves s, h and the target sums when a gradient is wanted. Under
    ``torch.func.vmap`` the vmap axis of s, the target and its sums is
    folded into the rows (s as a view where its strides allow); the
    frequency weights take no vmap axis.
    """

    @staticmethod
    def forward(s, target, abs_sum, weights, items, save):
        return edr_loss_forward(s, target, abs_sum, weights, items, save)

    @staticmethod
    def setup_context(ctx, inputs, output):
        s, _, abs_sum, _, items, save = inputs
        _, h = output
        ctx.mark_non_differentiable(h)
        ctx.set_materialize_grads(False)
        if save:
            ctx.save_for_backward(s, h, abs_sum)
        ctx.items = items

    @staticmethod
    def backward(ctx, g, _h):
        if g is None or not ctx.needs_input_grad[0]:
            return (None,) * 6
        s, h, abs_sum = ctx.saved_tensors
        return (edr_loss_backward(s, h, abs_sum, g.contiguous(), ctx.items),) + (None,) * 5

    @staticmethod
    def vmap(info, in_dims, s, target, abs_sum, weights, items, save):
        if in_dims[3] is not None:
            raise ValueError("edr loss: the frequency weights cannot carry a vmap axis")
        n = info.batch_size
        save = save or (torch.is_grad_enabled() and s.requires_grad)
        loss, h = _EdrLoss.apply(
            _fold_strided(s, in_dims[0], n), fold_vmap_axis(target, in_dims[1], n),
            fold_vmap_axis(abs_sum, in_dims[2], n), weights, items, save)
        if h.dim() == 3:
            return (loss.reshape(n, 1), h.reshape(n, -1, *h.shape[1:])), (0, 0)
        return (loss.reshape(n, 1), h), (0, None)


def edr_features_loss(
    target: torch.Tensor, abs_sum: torch.Tensor, s: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The EDR loss (a scalar) of the STFT ``s`` (B, F, frames) complex, or of
    its ERB-grouped magnitudes (B, bands, frames), against the target EDR
    (B, F, frames) dB and its |.| sums (B,): the sum over the items of
    sum_f w_f sum_m |target - D| / the item's sum. Unbatched (F, frames)
    inputs, with a scalar sum, give the single ratio. Differentiable in ``s``."""
    if target.dim() not in (2, 3):
        raise ValueError(f"edr loss: target EDR of shape {tuple(target.shape)}, "
                         "expected (F, frames) or (B, F, frames)")
    if target.requires_grad and torch.is_grad_enabled():
        raise ValueError("edr loss: the target EDR takes no gradient")
    if target.dim() == 2:
        s, target, abs_sum = s.unsqueeze(0), target.unsqueeze(0), abs_sum.reshape(1)
    tgt = target.expand(s.shape).contiguous()
    abs_sum = abs_sum.expand(s.shape[0]).contiguous()
    save = torch.is_grad_enabled() and s.requires_grad
    loss, _ = _EdrLoss.apply(s, tgt, abs_sum, weights, s.shape[0], save)
    return loss.reshape(())
