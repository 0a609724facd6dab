"""Batched irfft as four-step matmul transforms (port of ``ops/mxu_fft.py``).

A length-``n`` inverse DFT factors as ``n = n1 * n2`` into two batched
products with small DFT matrices and a twiddle multiply between them
(four-step Cooley-Tukey). The JAX package runs its directional loss's irfft
this way on the TPU's matrix units when ``use_mxu_fft`` is set (off by
default); here the same transform runs as two ``torch.matmul`` products:

* each complex product is ONE real block product, the re/im planes stacked
  on the contraction axis against [[Wr, Wi], [-Wi, Wr]];
* a length-n irfft is one length-n/2 complex inverse DFT plus O(n) twiddles
  (z[t] = x[2t] + i x[2t+1] packing);
* ``out_start`` / ``out_stop`` compute only the output rows needed (the
  EDC losses read about a quarter of the IR), shrinking the second product.

The constants are made in float64 on the host once per length and window,
then kept in float32 on each device that uses them. Autograd gives the
transpose through the same products. Lengths that are not powers of two (or
below 8) and empty windows fall back to ``torch.fft.irfft``, as in JAX.

Derivation (inverse kernel w = exp(+2i pi / m), j = j1*n2 + j2,
t = t2*n1 + t1):

    Z[t2*n1 + t1] = sum_{j2} W2[j2,t2] * T[t1,j2] *
                    sum_{j1} z[j1*n2 + j2] W1[j1,t1]

with W1[j1,t1] = exp(2i pi j1 t1 / n1), W2[j2,t2] = exp(2i pi j2 t2 / n2),
T[t1,j2] = exp(2i pi j2 t1 / m).
"""

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _split(n: int) -> Tuple[int, int]:
    """n = n1 * n2 with n1, n2 near sqrt(n) (n must be a power of two)."""
    assert n & (n - 1) == 0 and n >= 4, "power-of-two length required"
    p = n.bit_length() - 1
    n1 = 1 << ((p + 1) // 2)
    return n1, n // n1


def _block(w: np.ndarray) -> np.ndarray:
    """[[Wr, Wi], [-Wi, Wr]] (2a, 2c): one real product per complex one.

    With planes stacked on the contraction axis ([zr; zi], length 2a), the
    product's two output halves are the result's re/im planes.
    """
    wr, wi = w.real, w.imag
    return np.block([[wr, wi], [-wi, wr]]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _ifft_constants(m: int, t2_lo: int, t2_hi: int):
    """Host constants (float64 made, float32 kept) of the unscaled inverse DFT
    of length m, restricted to output rows t = t2*n1 + t1 with t2 in
    [t2_lo, t2_hi): (n1, n2, W1 block, twiddle re, twiddle im, W2 block)."""
    n1, n2 = _split(m)
    w1 = np.exp(2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    t2 = np.arange(t2_lo, t2_hi)
    w2 = np.exp(2j * np.pi * np.outer(np.arange(n2), t2) / n2)
    tw = np.exp(2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / m)
    return (
        n1,
        n2,
        _block(w1),
        np.ascontiguousarray(tw.real, np.float32),
        np.ascontiguousarray(tw.imag, np.float32),
        _block(w2),
    )


_ON_DEVICE: Dict[tuple, tuple] = {}


def _device_constants(m: int, t2_lo: int, t2_hi: int, device: torch.device) -> tuple:
    """:func:`_ifft_constants` as float32 tensors on ``device``, copied there
    once (before any captured step that reads them)."""
    key = (m, t2_lo, t2_hi, device)
    if key not in _ON_DEVICE:
        n1, n2, *arrays = _ifft_constants(m, t2_lo, t2_hi)
        _ON_DEVICE[key] = (n1, n2) + tuple(torch.as_tensor(a, device=device) for a in arrays)
    return _ON_DEVICE[key]


@functools.lru_cache(maxsize=16)
def _rotation(n: int) -> np.ndarray:
    """exp(2i pi k / n), k < n / 2, made in float64, kept as complex64."""
    return np.exp(2j * np.pi * np.arange(n // 2) / n).astype(np.complex64)


def _device_rotation(n: int, device: torch.device) -> torch.Tensor:
    key = ("rot", n, device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.as_tensor(_rotation(n), device=device)
    return _ON_DEVICE[key]


def ifft_matmul_unscaled(
    z: torch.Tensor,
    m: int,
    t2_lo: int = 0,
    t2_hi: Optional[int] = None,
) -> torch.Tensor:
    """Unscaled inverse DFT (sum_j z[j] e^{+2i pi jt/m}) over the last axis.

    Returns rows t = t2*n1 + t1 for t2 in [t2_lo, t2_hi) as complex64 of
    shape (..., (t2_hi - t2_lo) * n1); the full transform by default.
    """
    n1, n2 = _split(m)
    if t2_hi is None:
        t2_hi = n2
    n1, n2, w1b, twr, twi, w2b = _device_constants(m, t2_lo, t2_hi, z.device)
    batch = z.shape[:-1]
    zr = z.real.reshape(batch + (n1, n2)).to(torch.float32)
    zi = z.imag.reshape(batch + (n1, n2)).to(torch.float32)
    # step 1: contract j1, the planes stacked on the j1 axis, one product
    # A2[..., (t1 | plane), j2] = sum_{j1|plane} W1b[(j1 | plane), (t1 | plane)] Z2[..., j1|plane, j2]
    z2 = torch.cat([zr, zi], dim=-2)  # (..., 2 n1, n2)
    a2 = torch.matmul(w1b.T, z2)
    ar, ai = a2[..., :n1, :], a2[..., n1:, :]
    # step 2: the twiddle T[t1, j2], elementwise
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # step 3: contract j2 (the minor axis), the planes stacked on j2, one product
    b2 = torch.cat([br, bi], dim=-1)  # (..., n1, 2 n2)
    x2 = torch.matmul(b2, w2b)
    k = t2_hi - t2_lo
    out = torch.complex(x2[..., :k], x2[..., k:])  # (..., t1, t2)
    # Z[t2*n1 + t1]: transpose to (..., t2, t1), then flatten
    return out.transpose(-1, -2).reshape(batch + (k * n1,))


def irfft_matmul(
    h: torch.Tensor,
    n: int,
    out_start: int = 0,
    out_stop: Optional[int] = None,
) -> torch.Tensor:
    """``torch.fft.irfft(h, n)[..., out_start:out_stop]`` as matmul transforms.

    ``h``: (..., n//2 + 1) complex half-spectrum, power-of-two ``n``. The
    window is rounded out to the transform's row granularity inside, so
    exactly ``out_stop - out_start`` samples return.
    """
    m = n // 2
    assert h.shape[-1] == m + 1, (tuple(h.shape), n)
    if out_stop is None:
        out_stop = n
    # the factorization needs a power-of-two length (>= 8, so that m splits)
    # and a non-empty window; anything else takes the library's irfft with
    # the same slicing
    if n & (n - 1) or n < 8 or not 0 <= out_start < out_stop <= n:
        return torch.fft.irfft(h, n, dim=-1)[..., out_start:out_stop]
    h = h.to(torch.complex64)
    h_k = h[..., :m]
    h_mk = h[..., 1:].flip(-1)  # H[m - k], k = 0..m-1
    a = 0.5 * (h_k + torch.conj(h_mk))
    b = (-0.5j) * (torch.conj(h_mk) - h_k) * _device_rotation(n, h.device)
    # z[t] = x[2t] + i x[2t+1] = (1/m) * unscaled_ifft(a + b); the window
    # [out_start, out_stop) maps to z rows t in [start // 2, stop // 2)
    n1, n2 = _split(m)
    t2_lo = (out_start // 2) // n1
    t2_hi = min(((out_stop - 1) // 2) // n1 + 1, n2)
    z = ifft_matmul_unscaled(a + b, m, t2_lo, t2_hi) * (1.0 / m)
    x = torch.stack([z.real, z.imag], dim=-1)
    x = x.reshape(h.shape[:-1] + ((t2_hi - t2_lo) * n1 * 2,))
    lo = out_start - t2_lo * n1 * 2
    return x[..., lo:lo + (out_stop - out_start)].to(torch.float32)
