"""Real spherical-harmonic machinery (copy of ``diffgfdn_tpu/ops/sph.py``, host numpy).

Provides:
* ``sh_matrix`` — real SH basis (N3D/orthonormal, Condon-Shortley removed);
* modal beamformer weights (cardioid/in-phase, max-rE, Butterworth);
* ``design_sph_filterbank`` — analysis/synthesis matrices for sector
  processing with energy normalization and exact reconstruction
  (analysis ∘ synthesis = identity);
* ``t_design_directions`` — small spherical t-designs (icosahedron 5-design
  for 2nd-order work) plus a Fibonacci fallback;
* ``cart_to_sph`` / ``sph_to_cart``.

The SH rotation functions are not copied yet (ROADMAP A13).
"""

from math import factorial
from typing import Optional, Tuple

import numpy as np
from scipy.special import eval_legendre, lpmv


def _sh_norm(n: int, m: int) -> float:
    """Orthonormal real-SH normalization sqrt((2n+1)/(4pi) (n-|m|)!/(n+|m|)!)."""
    m = abs(m)
    return np.sqrt((2 * n + 1) / (4 * np.pi) * factorial(n - m) / factorial(n + m))


def sh_matrix(n_max: int, azi: np.ndarray, colat: np.ndarray) -> np.ndarray:
    """Real spherical-harmonic basis Y of shape (num_dirs, (n_max+1)^2).

    ``azi`` is azimuth (rad), ``colat`` the polar/zenith angle (rad).
    Components ordered ACN: index n^2 + n + m. Orthonormal ("real"/N3D over
    sqrt(4pi)) convention: for a spherical t-design with t >= 2*n_max,
    (4*pi/J) * Y^T Y = I.
    """
    azi = np.atleast_1d(np.asarray(azi, dtype=np.float64))
    colat = np.atleast_1d(np.asarray(colat, dtype=np.float64))
    num_dirs = azi.shape[0]
    q = (n_max + 1) ** 2
    y = np.zeros((num_dirs, q))
    cos_colat = np.cos(colat)
    for n in range(n_max + 1):
        for m in range(-n, n + 1):
            # associated Legendre without Condon-Shortley (lpmv includes it)
            p = lpmv(abs(m), n, cos_colat) * (-1.0) ** abs(m)
            norm = _sh_norm(n, m)
            if m > 0:
                val = np.sqrt(2.0) * norm * p * np.cos(m * azi)
            elif m < 0:
                val = np.sqrt(2.0) * norm * p * np.sin(abs(m) * azi)
            else:
                val = norm * p
            y[:, n * n + n + m] = val
    return y


def repeat_per_order(c_n: np.ndarray) -> np.ndarray:
    """Expand per-order weights (n_max+1,) to per-component ((n_max+1)^2,)."""
    c_n = np.asarray(c_n, dtype=np.float64)
    n_max = len(c_n) - 1
    return np.concatenate([np.full(2 * n + 1, c_n[n]) for n in range(n_max + 1)])


# ------------------------------ modal weights -------------------------------


def cardioid_modal_weights(n_max: int) -> np.ndarray:
    """In-phase ("cardioid") weights c_n = N!(N+1)! / ((N+n+1)!(N-n)!).

    Produces the ((1+cos t)/2)^N pattern; the reference maps its MAX_DI
    beamformer type to these weights (spatial_sampling/model.py:52-54).
    """
    return np.array(
        [
            factorial(n_max) * factorial(n_max + 1)
            / (factorial(n_max + n + 1) * factorial(n_max - n))
            for n in range(n_max + 1)
        ]
    )


def maxre_modal_weights(n_max: int) -> np.ndarray:
    """max-rE weights c_n = P_n(cos(137.9deg / (N + 1.51)))."""
    x = np.cos(np.deg2rad(137.9) / (n_max + 1.51))
    return np.array([eval_legendre(n, x) for n in range(n_max + 1)])


def butterworth_modal_weights(n_max: int, k: int = 5, n_c: int = 3) -> np.ndarray:
    """Butterworth-rolloff weights c_n = 1/sqrt(1 + (n/n_c)^(2k))."""
    n = np.arange(n_max + 1, dtype=np.float64)
    return 1.0 / np.sqrt(1.0 + (n / float(n_c)) ** (2 * k))


def modal_weights(beamformer_type: Optional[str], n_max: int) -> np.ndarray:
    """Dispatch on BeamformerType values (strings or enum)."""
    name = getattr(beamformer_type, "value", beamformer_type)
    if name == "max_directivity":
        return cardioid_modal_weights(n_max)
    if name == "max_re":
        return maxre_modal_weights(n_max)
    if name == "butterworth":
        return butterworth_modal_weights(n_max)
    return np.ones(n_max + 1)


# ---------------------------- sector filterbank -----------------------------


def design_sph_filterbank(
    n_max: int,
    azi: np.ndarray,
    colat: np.ndarray,
    c_n: np.ndarray,
    mode: str = "energy",
) -> Tuple[np.ndarray, np.ndarray]:
    """Analysis/synthesis matrices for SH sector (directional) processing.

    Analysis A (J x Q): sector signals s = A @ x_sh, beam patterns shaped by
    per-order weights ``c_n`` steered to the J directions. In ``energy`` mode
    A is scaled so a diffuse SH field keeps its total energy across sectors:
    trace(A^T A) = Q. Synthesis B (J x Q) satisfies B^T @ s = x_sh exactly
    (B^T = pinv(A)), giving perfect reconstruction — the invariant the
    reference's spherical filterbank tests assert (tests/test.py:453-493).
    """
    y = sh_matrix(n_max, azi, colat)  # (J, Q)
    c_nm = repeat_per_order(np.asarray(c_n))
    a = y * c_nm[None, :]
    j, q = a.shape
    if mode == "energy":
        scale = np.sqrt(q / np.trace(a.T @ a))
        a = a * scale
    b = np.linalg.pinv(a).T  # (J, Q); B^T @ A = I for J >= Q
    return a, b


# ------------------------------- t-designs ----------------------------------

# Icosahedron vertices: a spherical 5-design (12 points) — exact for SH
# products up to order 2 (the dataset's ambisonic order).
_PHI = (1.0 + np.sqrt(5.0)) / 2.0
_ICOSAHEDRON = np.array(
    [
        [0, 1, _PHI], [0, -1, _PHI], [0, 1, -_PHI], [0, -1, -_PHI],
        [1, _PHI, 0], [-1, _PHI, 0], [1, -_PHI, 0], [-1, -_PHI, 0],
        [_PHI, 0, 1], [-_PHI, 0, 1], [_PHI, 0, -1], [-_PHI, 0, -1],
    ],
    dtype=np.float64,
)
_ICOSAHEDRON /= np.linalg.norm(_ICOSAHEDRON, axis=1, keepdims=True)


def t_design_directions(degree: int = 5) -> np.ndarray:
    """Directions (azi, colat) of a spherical t-design, shape (2, J).

    degree <= 5 returns the icosahedron 5-design (12 points, the grid the
    reference dataset uses). Higher degrees fall back to a Fibonacci sphere
    with enough points for near-exact integration.
    """
    if degree <= 5:
        xyz = _ICOSAHEDRON
    else:
        n_pts = 2 * (degree + 1) ** 2
        i = np.arange(n_pts) + 0.5
        ga = np.pi * (3.0 - np.sqrt(5.0))
        z = 1.0 - 2.0 * i / n_pts
        r = np.sqrt(1.0 - z ** 2)
        xyz = np.stack([r * np.cos(ga * i), r * np.sin(ga * i), z], axis=-1)
    azi = np.arctan2(xyz[:, 1], xyz[:, 0])
    colat = np.arccos(np.clip(xyz[:, 2], -1.0, 1.0))
    return np.stack([azi, colat], axis=0)


def cart_to_sph(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(azi, colat) from cartesian unit vectors of shape (..., 3)."""
    azi = np.arctan2(xyz[..., 1], xyz[..., 0])
    colat = np.arccos(np.clip(xyz[..., 2] / np.linalg.norm(xyz, axis=-1), -1, 1))
    return azi, colat


def sph_to_cart(azi: np.ndarray, colat: np.ndarray) -> np.ndarray:
    """Cartesian unit vectors from (azi, colat)."""
    return np.stack(
        [np.sin(colat) * np.cos(azi), np.sin(colat) * np.sin(azi), np.cos(colat)],
        axis=-1,
    )
