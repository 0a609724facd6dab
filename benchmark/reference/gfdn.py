"""Plain PyTorch and NumPy reference of the grid GFDN (position-conditioned
output heads), its training losses, the io-gain normalization and Adam.

It is written from the published model (orchidas/DiffGFDN, "Differentiable
grouped feedback delay networks") and imports nothing of the program under
test. It works out again what the program derives from a configuration:
the delay lengths from the configuration's seed, the GEQ absorption
cascades from the decay times, the SVF cutoffs, the early spectra, the
int8-block coding of large target sets and the target EDC and EDR.

Parameters are a dict {name: tensor} under the names the benchmark draws
them with (``input_gains`` (N, 1), ``output_gains`` (N, 1),
``feedback_loop.M`` (G, n, n), ``<head>.mlp.dense.<i>.weight`` (out, in),
``.bias``, ``<head>.mlp.norm.<i>.weight``, ``.bias``; ``<head>`` is
``output_filters`` for SVF heads and ``output_scalars`` for scalar heads).

A model computes in the real dtype it is given (float32 or float64) from
the configuration's float32 inputs: the weights, the data, and the delay
terms z^d, which are complex64 powers of the complex64 bins as the
configuration computes them and are then cast. float32 matrix products
follow ``torch.backends.cuda.matmul.allow_tf32``, which the caller sets.
"""

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

EPS_F32 = float(np.finfo(np.float32).eps)
LAYER_NORM_EPS = 1e-6
QUANT_MIN_BYTES = 64 * 1024 * 1024  # target sets this large travel as int8 blocks
QUANT_BLOCK = 256
LOWSHELF, HIGHSHELF, PEAKING = 3, 4, 5


# ------------------------------ configuration ------------------------------

def _is_prime(n: int) -> bool:
    return n >= 2 and all(n % p for p in range(2, int(n ** 0.5) + 1))


def delay_lengths(cfg: dict) -> List[int]:
    """Prime delay lengths: a permutation (``RandomState(seed)``) of the primes
    in [lo, hi) samples of ``delay_range_ms``, N - 1 of them, then the first
    prime above hi."""
    fs = float(cfg["sample_rate"])
    lo = int(cfg["delay_range_ms"][0] * 1e-3 * fs)
    hi = int(cfg["delay_range_ms"][1] * 1e-3 * fs)
    primes = np.array([p for p in range(lo, hi) if _is_prime(p)], dtype=np.int64)
    order = np.random.RandomState(cfg["seed"]).permutation(len(primes))
    out = [int(p) for p in primes[order][: cfg["num_delay_lines"] - 1]]
    nxt = hi + 1
    while not _is_prime(nxt):
        nxt += 1
    return out + [nxt]


def octave_centres(start: float = 31.25, end: float = 16000.0) -> np.ndarray:
    out, f = [], start
    while f < end:
        f *= 2.0
        out.append(f)
    return np.array(out)


def svf_cutoffs(fs: float) -> np.ndarray:
    """pi f / fs at the low-shelf crossover, the octave centres and the
    high-shelf crossover."""
    c = octave_centres()
    freqs = np.concatenate(([c[0] / math.sqrt(2.0)], c, [c[-1] * math.sqrt(2.0)]))
    return np.pi * freqs / fs


# --------------------------------- GEQ -------------------------------------

def _shelf(fc: float, g: float, high: bool, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    t = math.tan(math.pi * fc / fs)
    g2, g4, r2 = g ** 0.5, g ** 0.25, math.sqrt(2.0)
    b = g2 * np.array([g2 * t * t + r2 * t * g4 + 1.0, 2.0 * g2 * t * t - 2.0,
                       g2 * t * t - r2 * t * g4 + 1.0])
    a = np.array([g2 + r2 * t * g4 + t * t, 2.0 * t * t - 2.0 * g2, g2 - r2 * t * g4 + t * t])
    return (a * g, b) if high else (b, a)


def _peak(fc: float, g: float, q: float, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    w = 2.0 * math.pi * fc / fs
    t = math.tan(w / q / 2.0)
    sg = math.sqrt(g)
    return (np.array([sg + g * t, -2.0 * sg * math.cos(w), sg - g * t]),
            np.array([sg + t, -2.0 * sg * math.cos(w), sg - t]))


def _geq_sections(centres, shelves, gains_db, fs) -> Tuple[np.ndarray, np.ndarray]:
    """(b, a) each (sections, 3): a broadband gain, a low shelf, a peaking
    filter a centre (Q = sqrt(R) / (R - 1), R = 2.7), a high shelf."""
    r = 2.7
    bs, as_ = [], []
    for k, gdb in enumerate(gains_db):
        g = 10.0 ** (gdb / 20.0)
        if k == 0:
            b, a = np.array([g, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])
        elif k == 1:
            b, a = _shelf(shelves[0], g, False, fs)
        elif k == len(gains_db) - 1:
            b, a = _shelf(shelves[1], g, True, fs)
        else:
            b, a = _peak(centres[k - 2], g, math.sqrt(r) / (r - 1.0), fs)
        bs.append(b)
        as_.append(a)
    return np.array(bs), np.array(as_)


def design_geq(target_db: np.ndarray, centres: np.ndarray, shelves: np.ndarray,
               fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """Command gains of the cascade fitted, by bounded least squares on 101
    log-spaced control frequencies, to the target (dB) at [1 Hz, the centres,
    fs / 2.1], each section's response probed at 10 dB."""
    from scipy.optimize import lsq_linear

    control = np.round(np.logspace(0.0, np.log10(fs / 2.1), 101))
    xp = np.concatenate(([1.0], centres, [fs / 2.1]))
    keep, last = [], -np.inf
    for f in xp:  # a strictly rising abscissa for the interpolation
        keep.append(f > last)
        last = max(last, f)
    target = np.interp(control, xp[keep], np.asarray(target_db, np.float64)[keep])
    n = len(centres) + 3
    proto_b, proto_a = _geq_sections(centres, shelves, np.full(n, 10.0), fs)
    zi = np.exp(-2j * np.pi * control / fs)
    powers = np.stack([np.ones_like(zi), zi, zi * zi])
    probe = np.stack([
        20.0 * np.log10(np.abs((proto_b[k] / proto_a[k, 0]) @ powers
                               / ((proto_a[k] / proto_a[k, 0]) @ powers + 1e-10)) + 1e-12)
        for k in range(n)], axis=1) / 10.0
    upper = np.array([np.inf] + [20.0] * (n - 1))
    gains = lsq_linear(probe, target, bounds=(-upper, upper), max_iter=200).x
    return _geq_sections(centres, shelves, gains, fs)


def absorption(cfg: dict, decay_times: np.ndarray, band_hz, delays: List[int]) -> dict:
    """{"sos": (N, K, 3, 2) float64 GEQ cascades} when the configuration uses
    absorption filters and the decay times are per band (bands, G), else
    {"gains": (N,) per-line gains 10^(-3 d / (fs T60_g))}."""
    fs = float(cfg["sample_rate"])
    g = cfg["num_groups"]
    nper = len(delays) // g
    t60 = np.asarray(decay_times, np.float64)
    filters = cfg.get("decay_filter_config", {}).get("use_absorption_filters", True)
    if filters and t60.ndim == 2 and t60.shape[0] > 1:
        centres = np.asarray(band_hz, np.float64)
        shelves = np.array([centres[0] / math.sqrt(2.0), centres[-1] * math.sqrt(2.0)])
        out = []
        for line, d in enumerate(delays):
            per_band = (10.0 ** (-3.0 / fs / t60[:, line // nper])) ** d
            target = np.concatenate([per_band[:1] * 0.5, per_band, per_band[-1:] * 0.5])
            b, a = design_geq(20.0 * np.log10(target + 1e-12), centres, shelves, fs)
            out.append(np.stack([b, a], axis=-1))
        return {"sos": np.stack(out)}
    t60 = t60.reshape(-1)[:g]
    d = np.asarray(delays, np.float64)
    return {"gains": 10.0 ** (-3.0 * d / (fs * np.repeat(t60, nper)))}


# ------------------------------ data features ------------------------------

def z_values(nfft: int, device) -> torch.Tensor:
    w = 2.0 * np.pi * np.arange(nfft // 2 + 1) / nfft
    return torch.as_tensor(np.exp(1j * w).astype(np.complex64), device=device)


def early_segment(rirs: np.ndarray, fs: float) -> np.ndarray:
    """The first 20 ms of each RIR, its last 2.5 ms faded out by the falling
    half of a 5 ms Hann window."""
    mix, win = int(20e-3 * fs), int(5e-3 * fs)
    early = np.array(rirs[..., :mix], dtype=np.float32)
    half = win // 2
    early[..., -half:] *= np.hanning(win)[win - half:]
    return early


def coded_targets(rirs: np.ndarray, total_bytes: int) -> np.ndarray:
    """The targets as the trainer sees them: a set of ``total_bytes`` or more
    of float32 goes as int8 per block of 256 samples, each block scaled by
    its |max| / 127."""
    x = np.ascontiguousarray(rirs, np.float32)
    if total_bytes < QUANT_MIN_BYTES:
        return x
    r, t = x.shape
    blocks = np.pad(x, ((0, 0), (0, (-t) % QUANT_BLOCK))).reshape(r, -1, QUANT_BLOCK)
    peak = np.abs(blocks).max(axis=-1, keepdims=True)
    peak = np.where(peak == 0, np.float32(1.0), peak)
    q = np.clip(np.round(blocks / peak * 127.0), -127, 127).astype(np.float32)
    return (q * (peak / np.float32(127.0))).reshape(r, -1)[:, :t]


def db(x: torch.Tensor, squared: bool = True) -> torch.Tensor:
    return torch.clamp((10.0 if squared else 20.0) * torch.log10(torch.abs(x) + EPS_F32),
                       min=-200.0)


def backward_energy(x: torch.Tensor) -> torch.Tensor:
    """sum_{u >= t} x(u)^2 along the last axis, summed from the end."""
    return torch.flip(torch.cumsum(torch.flip(x * x, (-1,)), -1), (-1,))


def stft(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """One-sided STFT, no centring, periodic Hann: (..., T) -> (..., win/2+1, frames)."""
    t = x.shape[-1]
    pad = max(0, win - t)
    pad += (-(t + pad - win)) % hop
    x = torch.nn.functional.pad(x, (0, pad))
    frames = x.unfold(-1, win, hop)
    window = torch.as_tensor(np.hanning(win + 1)[:-1], dtype=x.dtype, device=x.device)
    return torch.fft.rfft(frames * window, n=win, dim=-1).transpose(-1, -2)


def edr_db(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    s = stft(x, win, hop)
    return db(torch.flip(torch.cumsum(torch.flip(s.real ** 2 + s.imag ** 2, (-1,)), -1), (-1,)))


class Sizes:
    """The loss windows of a configuration and its decay times."""

    def __init__(self, cfg: dict, decay_times: np.ndarray):
        fs = float(cfg["sample_rate"])
        self.nfft = int(cfg["trainer_config"]["num_freq_bins"])
        self.mixing = int(20.0 * 1e-3 * fs)
        self.max_len = int(float(np.max(decay_times)) * 1e3 * 1e-3 * fs)
        self.edc_end = min(self.max_len, self.nfft)
        self.win = min(2 ** 12, 2 ** int(np.log2(max(self.nfft // 4, 8))))
        self.hop = self.win // 2


def target_features(coded: np.ndarray, sizes: Sizes, device, dtype=torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Target EDC (dB) from the mixing time to the EDC's end, target EDR (dB)
    and its |.| sum, of coded target RIRs (B, T) zero padded or cut to nfft."""
    x = torch.as_tensor(coded, device=device).to(dtype)[:, : sizes.nfft]
    x = torch.nn.functional.pad(x, (0, sizes.nfft - x.shape[1]))
    edc = db(backward_energy(x[:, sizes.mixing:sizes.edc_end]))
    edr = edr_db(x, sizes.win, sizes.hop)
    return {"edc": edc, "edr": edr, "edr_sum": torch.sum(torch.abs(edr), dim=(-2, -1))}


# --------------------------------- model -----------------------------------

def skew_exp(m: torch.Tensor) -> torch.Tensor:
    """exp(skew(M)), skew from the strict upper triangle."""
    a = torch.triu(m, diagonal=1)
    return torch.linalg.matrix_exp(a - a.transpose(-1, -2))


def fourier_features(pos: torch.Tensor, num: int) -> torch.Tensor:
    """[sin(f pi x), cos(f pi x)] per frequency f (log-spaced over [1, 32])
    and coordinate: (B, 3) -> (B, 6 num)."""
    f = torch.exp(torch.linspace(0.0, math.log(32.0), num, dtype=torch.float32,
                                 device=pos.device)).to(pos.dtype)
    phase = f[None, :, None] * math.pi * pos[:, None, :]
    return torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1).reshape(pos.shape[0], -1)


def mlp(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Dense, LayerNorm, ReLU per hidden layer, then the output Dense."""
    n = sum(1 for k in p if k.startswith(prefix + "dense.") and k.endswith(".weight"))
    for i in range(n - 1):
        x = torch.nn.functional.linear(x, p[f"{prefix}dense.{i}.weight"],
                                       p[f"{prefix}dense.{i}.bias"])
        x = torch.nn.functional.layer_norm(x, x.shape[-1:], p[f"{prefix}norm.{i}.weight"],
                                           p[f"{prefix}norm.{i}.bias"], LAYER_NORM_EPS)
        x = torch.relu(x)
    return torch.nn.functional.linear(x, p[f"{prefix}dense.{n - 1}.weight"],
                                      p[f"{prefix}dense.{n - 1}.bias"])


def between(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.sigmoid(x)


def cascade(b: torch.Tensor, a: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """prod_k (b0 + b1 z^-1 + b2 z^-2) / (a0 + a1 z^-1 + a2 z^-2): (..., K, 3)
    real coefficients, z (F,) -> (..., F) complex, each quadratic evaluated
    point by point, in the coefficients' precision."""
    w = 1.0 / z.to(torch.complex128 if b.dtype == torch.float64 else torch.complex64)
    w2 = w * w

    def quadratic(c):
        return c[..., 0:1] + c[..., 1:2] * w + c[..., 2:3] * w2

    return torch.prod(quadratic(b) / quadratic(a), dim=-2)


def svf_biquads(raw: torch.Tensor, cutoffs: torch.Tensor, rho: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State-variable-filter cascades from raw head outputs (..., K, 2):
    resonance in (1e-6, 1), gain in (-6, 6) dB; a low shelf, peaking
    sections, a high shelf at the cutoffs f = pi fc / fs; pole and zero radii
    scaled by ``rho``."""
    r = between(raw[..., 0], 1e-6, 1.0)
    g = 10.0 ** (between(raw[..., 1], -6.0, 6.0) / 20.0)
    k = raw.shape[-2]
    kind = torch.full((k,), PEAKING, device=raw.device)
    kind[0], kind[-1] = LOWSHELF, HIGHSHELF
    one = torch.ones_like(g)
    m_lp = torch.where(kind == LOWSHELF, g, one)
    m_hp = torch.where(kind == HIGHSHELF, g, one)
    m_bp = torch.where(kind == PEAKING, 2.0 * r * g, 2.0 * r * torch.sqrt(g))
    f = cutoffs
    b = torch.stack([f * f * m_lp + f * m_bp + m_hp, (2.0 * f * f * m_lp - 2.0 * m_hp) * rho,
                     (f * f * m_lp - f * m_bp + m_hp) * rho ** 2], dim=-1)
    a = torch.stack([f * f + 2.0 * r * f + 1.0, (2.0 * f * f - 2.0) * one * rho,
                     (f * f - 2.0 * r * f + 1.0) * rho ** 2], dim=-1)
    return b, a


class GridGFDN:
    """H(z) = c(z)^T (D(z) Gamma(z)^-1 - A)^-1 b + early(z) per receiver, with
    zero coupling (block-diagonal loop: A's blocks exp(skew(M_g))^2) and
    position-conditioned output heads."""

    def __init__(self, cfg: dict, decay_times: np.ndarray, band_hz, device,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = device
        self.real = dtype
        self.cplx = torch.complex128 if dtype == torch.float64 else torch.complex64
        self.g = int(cfg["num_groups"])
        self.delays = delay_lengths(cfg)
        self.nper = len(self.delays) // self.g
        head = cfg.get("output_filter_config", {})
        self.svf = bool(head.get("use_svfs", True))
        self.num_features = int(head.get("num_fourier_features", 10))
        self.rho = float(head.get("compress_pole_factor", 1.0))
        absorb = absorption(cfg, decay_times, band_hz, self.delays)
        # the configuration's float32 values of the designed coefficients
        self.sos = None if "sos" not in absorb else torch.as_tensor(
            absorb["sos"], dtype=torch.float32, device=device).to(dtype)
        self.gains = None if "gains" not in absorb else torch.as_tensor(
            absorb["gains"], dtype=torch.float32, device=device).to(dtype)
        self.cutoffs = torch.as_tensor(svf_cutoffs(float(cfg["sample_rate"])),
                                       dtype=torch.float32, device=device).to(dtype)
        self.d = torch.as_tensor(np.asarray(self.delays, np.float32), device=device)

    def _delay_terms(self, z: torch.Tensor) -> torch.Tensor:
        """z^d (G, F, n): complex64 powers of the complex64 bins, as the
        configuration computes them, cast to the model's precision."""
        z = z.to(torch.complex64)
        return (z[None, :, None] ** self.d.reshape(self.g, 1, self.nper)).to(self.cplx)

    def loop_blocks(self, p, z: torch.Tensor) -> torch.Tensor:
        """(G, F, n, n): diag(z^d / Gamma(z)) - exp(skew(M_g))^2."""
        if self.sos is not None:
            inv_gamma = 1.0 / cascade(self.sos[..., 0], self.sos[..., 1], z)  # (N, F)
            inv_gamma = inv_gamma.reshape(self.g, self.nper, -1).transpose(1, 2)
        else:
            inv_gamma = (1.0 / self.gains).reshape(self.g, 1, self.nper)
        o = skew_exp(p["feedback_loop.M"])
        a = torch.matmul(o, o).to(self.cplx)
        return torch.diag_embed(self._delay_terms(z) * inv_gamma) - a[:, None]

    def sub_inverse(self, p, z: torch.Tensor) -> torch.Tensor:
        """Each lossless sub-FDN's (diag(z^d) - exp(skew(M_g)))^-1, (G, F, n, n)."""
        o = skew_exp(p["feedback_loop.M"]).to(self.cplx)
        return torch.linalg.inv(torch.diag_embed(self._delay_terms(z)) - o[:, None])

    def sub_outputs(self, p, z: torch.Tensor, inv=None) -> torch.Tensor:
        """(F, G): sum_n c_n (P_g b_g)_n of each sub-FDN."""
        inv = self.sub_inverse(p, z) if inv is None else inv
        b = p["input_gains"].reshape(self.g, self.nper).to(self.cplx)
        c = p["output_gains"].reshape(self.g, self.nper).to(self.cplx)
        return torch.einsum("gn,gfnm,gm->fg", c, inv, b)

    @torch.no_grad()
    def norm_scales(self, p, z: torch.Tensor) -> torch.Tensor:
        """Each group's io-gain normalization scale E_f[|H_sub_g|^2]^(1/4), (G,)."""
        h = self.sub_outputs(p, z)
        return torch.mean(torch.abs(h) ** 2, dim=0) ** 0.25

    @torch.no_grad()
    def normalize(self, p, z: torch.Tensor) -> torch.Tensor:
        """Divide each group's b and c by :meth:`norm_scales`, in place; the scales."""
        scale = self.norm_scales(p, z)
        per_line = torch.repeat_interleave(scale, self.nper)[:, None]
        p["input_gains"].div_(per_line)
        p["output_gains"].div_(per_line)
        return scale

    def response(self, p, z: torch.Tensor, pos: torch.Tensor, norm_pos: torch.Tensor,
                 early: torch.Tensor) -> torch.Tensor:
        """(B, F) complex at the receivers' positions; ``early`` (B, F) the
        early spectra added as the direct part."""
        blocks = self.loop_blocks(p, z)
        b = p["input_gains"][:, 0]
        c = p["output_gains"][:, 0]
        if self.svf:
            raw = mlp(p, "output_filters.mlp.", fourier_features(pos, self.num_features))
            raw = raw.reshape(pos.shape[0], self.g, -1, 2)
            hb, ha = svf_biquads(raw, self.cutoffs, self.rho)
            heads = cascade(hb, ha, z)  # (B, G, F)
            inv = torch.linalg.inv(blocks)
            s = torch.einsum("gfnm,gn,gm->fg", inv, c.reshape(self.g, self.nper).to(
                self.cplx), b.reshape(self.g, self.nper).to(self.cplx))
            h = torch.einsum("bgf,fg->bf", heads, s)
        else:
            raw = mlp(p, "output_scalars.mlp.", fourier_features(norm_pos, self.num_features))
            gains = between(raw.reshape(pos.shape[0], self.g), -1.0, 1.0)
            cs = torch.repeat_interleave(gains, self.nper, dim=1) * c  # (B, N)
            rhs = b.reshape(self.g, 1, self.nper, 1).to(self.cplx).expand(
                self.g, z.shape[0], self.nper, 1)
            q = torch.linalg.solve(blocks, rhs)[..., 0]  # (G, F, n)
            q = q.transpose(0, 1).reshape(z.shape[0], -1)  # (F, N)
            h = cs.to(self.cplx) @ q.T
        return h + early


# --------------------------------- losses ----------------------------------

def omni_losses(model: GridGFDN, p, h: torch.Tensor, target: Dict[str, torch.Tensor],
                sizes: Sizes, mask: Optional[torch.Tensor], z: torch.Tensor,
                sub_inv=None) -> Dict[str, torch.Tensor]:
    """EDC (masked when given) and EDR losses of the responses h (B, F), and
    with the colorless loss the sub-FDNs' spectral and sparsity terms."""
    tc = model.cfg["trainer_config"]
    rir = torch.fft.irfft(h, sizes.nfft, dim=-1)
    err = torch.abs(target["edc"] - db(backward_energy(rir[:, sizes.mixing:sizes.edc_end])))
    edc = torch.mean(err) if mask is None else \
        torch.sum(err * mask) / (torch.sum(mask) * err.shape[0] + 1e-9)
    edr = torch.abs(target["edr"] - edr_db(rir, sizes.win, sizes.hop))
    out = {"edc_loss": tc.get("edc_loss_weight", 1.0) * edc,
           "edr_loss": tc.get("edr_loss_weight", 1.0) * torch.sum(
               torch.sum(edr, dim=(-2, -1)) / target["edr_sum"])}
    if tc.get("use_colorless_loss", False):
        h_sub = torch.abs(model.sub_outputs(p, z, sub_inv))
        diff = torch.abs(h_sub - 1.0)
        if tc.get("use_asym_spectral_loss", False):
            terms = diff ** (2.0 + 2.0 * ((h_sub - 1.0) > 1.0).to(diff.dtype))
        else:
            terms = diff ** 2
        out["spectral_loss"] = tc.get("spectral_loss_weight", 1.0) * torch.sum(
            torch.mean(terms, dim=0))
        last = skew_exp(p["feedback_loop.M"])[-1]
        n = last.shape[-1]
        out["sparsity_loss"] = tc.get("sparsity_loss_weight", 1.0) * (
            -(torch.sum(torch.abs(last)) - n * math.sqrt(n)) / (n * (math.sqrt(n) - 1.0)))
    return out


def edc_mask(length: int, generator: torch.Generator, device) -> torch.Tensor:
    """A step's EDC time mask: Bernoulli(U(0, 1)) per sample, from ``generator``."""
    return torch.bernoulli(torch.rand(length, generator=generator, device=device),
                           generator=generator)


# ---------------------------------- Adam -----------------------------------

def learning_rate(cfg: dict, name: str) -> float:
    tc = cfg["trainer_config"]
    if "alpha" in name:
        return float(tc.get("coupling_angle_lr", 0.01))
    if any(k in name for k in ("input_gains", "output_gains", "output_scalars")):
        return float(tc.get("io_lr", 0.01))
    return float(tc.get("lr", 0.01))


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8) with each parameter's rate."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor]):
        self.lr = {k: learning_rate(cfg, k) for k in params}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(0.1 * g)
            self.v[k].mul_(0.999).add_(0.001 * g * g)
            p.sub_(self.lr[k] / c1 * self.m[k] / (torch.sqrt(self.v[k]) / math.sqrt(c2) + 1e-8))
