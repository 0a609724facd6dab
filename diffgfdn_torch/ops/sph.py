"""Real spherical-harmonic machinery (copy of ``diffgfdn_tpu/ops/sph.py``, host numpy).

Provides:
* ``sh_matrix`` — real SH basis (N3D/orthonormal, Condon-Shortley removed);
* modal beamformer weights (cardioid/in-phase, max-rE, Butterworth);
* ``design_sph_filterbank`` — analysis/synthesis matrices for sector
  processing with energy normalization and exact reconstruction
  (analysis ∘ synthesis = identity);
* ``t_design_directions`` — small spherical t-designs (icosahedron 5-design
  for 2nd-order work) plus a Fibonacci fallback;
* ``cart_to_sph`` / ``sph_to_cart``;
* SH rotations (``sh_rotation_matrix``, ``sh_rotation_yaw_pitch_roll``): the
  Ivanic-Ruedenberg recursion, in float64, for head rotation in the binaural
  renderer and the SRIR-to-BRIR conversion.
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


# ------------------------------- SH rotation --------------------------------


def rotation_matrix_zyz(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """3x3 rotation from z-y-z Euler angles (rad)."""

    def rz(a):
        return np.array(
            [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        )

    def ry(a):
        return np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        )

    return rz(alpha) @ ry(beta) @ rz(gamma)


def rotation_matrix_ypr(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """3x3 rotation from yaw (about z), pitch (about y), roll (about x)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


def sh_rotation_yaw_pitch_roll(
    n_max: int, yaw: float, pitch: float, roll: float = 0.0
) -> np.ndarray:
    """Real-SH rotation matrix for a yaw/pitch/roll head orientation."""
    return sh_rotation_matrix(n_max, rotation_matrix_ypr(yaw, pitch, roll))


def sh_rotation_matrix(n_max: int, rot: np.ndarray) -> np.ndarray:
    """Block-diagonal real-SH rotation matrix for a 3x3 rotation ``rot``.

    Ivanic & Ruedenberg recursion (J. Phys. Chem. 1996/1998 erratum);
    returns ((n_max+1)^2, (n_max+1)^2). Rotating SH coefficients x by R3 is
    x' = Rsh @ x with Rsh block-diagonal per order.
    """
    q = (n_max + 1) ** 2
    rsh = np.zeros((q, q))
    rsh[0, 0] = 1.0
    if n_max == 0:
        return rsh

    # order-1 block in ACN (m = -1, 0, 1) <-> cartesian (y, z, x)
    perm = np.array([1, 2, 0])  # ACN m=-1,0,1 maps to y,z,x
    r1 = rot[np.ix_(perm, perm)]
    rsh[1:4, 1:4] = r1

    blocks = {1: r1}
    for n in range(2, n_max + 1):
        prev = blocks[n - 1]
        cur = np.zeros((2 * n + 1, 2 * n + 1))
        for m1 in range(-n, n + 1):
            for m2 in range(-n, n + 1):
                u, v, w = _uvw(n, m1, m2)
                total = 0.0
                if u != 0:
                    total += u * _func_u(n, m1, m2, r1, prev)
                if v != 0:
                    total += v * _func_v(n, m1, m2, r1, prev)
                if w != 0:
                    total += w * _func_w(n, m1, m2, r1, prev)
                cur[m1 + n, m2 + n] = total
        blocks[n] = cur
        rsh[n * n : (n + 1) ** 2, n * n : (n + 1) ** 2] = cur
    return rsh


def _uvw(n, m1, m2):
    d = 1.0 if m1 == 0 else 0.0
    if abs(m2) < n:
        denom = (n + m2) * (n - m2)
    else:
        denom = (2 * n) * (2 * n - 1)
    u = np.sqrt((n + m1) * (n - m1) / denom)
    v = 0.5 * np.sqrt(
        (1 + d) * (n + abs(m1) - 1) * (n + abs(m1)) / denom
    ) * (1 - 2 * d)
    w = -0.5 * np.sqrt((n - abs(m1) - 1) * (n - abs(m1)) / denom) * (1 - d)
    return u, v, w


def _p(i, n, a, b, r1, prev):
    """Helper P_i^{a,b} from Ivanic-Ruedenberg (r1 indexed by m in {-1,0,1})."""
    ri1 = r1[i + 1, 1 + 1]
    rim1 = r1[i + 1, -1 + 1]
    ri0 = r1[i + 1, 0 + 1]
    if b == n:
        return ri1 * prev[a + (n - 1), n - 1 + (n - 1)] - rim1 * prev[
            a + (n - 1), -n + 1 + (n - 1)
        ]
    if b == -n:
        return ri1 * prev[a + (n - 1), -n + 1 + (n - 1)] + rim1 * prev[
            a + (n - 1), n - 1 + (n - 1)
        ]
    return ri0 * prev[a + (n - 1), b + (n - 1)]


def _func_u(n, m1, m2, r1, prev):
    return _p(0, n, m1, m2, r1, prev)


def _func_v(n, m1, m2, r1, prev):
    if m1 == 0:
        return _p(1, n, 1, m2, r1, prev) + _p(-1, n, -1, m2, r1, prev)
    if m1 > 0:
        if m1 == 1:
            return np.sqrt(2.0) * _p(1, n, 0, m2, r1, prev)
        return _p(1, n, m1 - 1, m2, r1, prev) - _p(-1, n, -m1 + 1, m2, r1, prev)
    if m1 == -1:
        return np.sqrt(2.0) * _p(-1, n, 0, m2, r1, prev)
    return _p(1, n, m1 + 1, m2, r1, prev) + _p(-1, n, -m1 - 1, m2, r1, prev)


def _func_w(n, m1, m2, r1, prev):
    if m1 == 0:
        return 0.0
    if m1 > 0:
        return _p(1, n, m1 + 1, m2, r1, prev) + _p(-1, n, -m1 - 1, m2, r1, prev)
    return _p(1, n, m1 - 1, m2, r1, prev) - _p(-1, n, -m1 + 1, m2, r1, prev)
