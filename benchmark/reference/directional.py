"""Plain PyTorch and NumPy reference of the directional (ambisonic) grid
GFDN: the SH-domain model, its directional EDC loss, the colorless and
sparsity losses and the per-step io-gain normalization.

It is written from the published model (orchidas/DiffGFDN,
``DiffDirectionalFDNVarReceiverPos`` and its trainer) and imports nothing of
the program under test; it shares the grid model's plain pieces with
``gfdn.py`` (the delay lengths, the scalar absorption, exp(skew(M)), the
Fourier features, the sub-FDN responses, ``db``, the Schroeder integral, the
EDC mask and Adam). With G groups of L = (order + 1)^2 delay lines, one a
spherical-harmonic (SH) channel:

* the loop: each group's block diag(z^d / gamma) - exp(skew(M_g))^2, its
  transpose solved against the group's input gains, q_g(z) = M_g(z)^-T b_g;
* the SH mix: h[b, l, f] = sum_g w[b, g, l] q[g, f, l], with w the
  receiver's weights from a residual MLP over 20 Fourier features of its
  normalized position (an input layer, residual blocks x + relu(LN(Wx + c)),
  the output layer), each group's L weights scaled to unit norm (+ 1e-6)
  and times the group's output gains;
* the band: h times the preset's subband filter (:func:`band_response`);
* the loss: the irfft of the B x L rows, cut to [mixing time, mixing time +
  T), beamformed to the J directions by the analysis matrix, the Schroeder
  EDC in dB against the common-slope amplitudes times the unit-norm decay
  envelopes in dB, the mean |difference| (over the EDC mask when given),
  times ``edc_loss_weight``; the colorless terms of the lossless sub-FDNs
  and the sparsity of the last group's exp(skew(M)).

Conventions: real SH of order 2 in ACN order, orthonormal over the sphere
(N3D / sqrt(4 pi)), without the Condon-Shortley phase, written out below in
Cartesian form; directions as (azimuth, elevation) in radians; the analysis
matrix is the max-directivity (in-phase, "cardioid") beam pattern, order
weights N! (N + 1)! / ((N + n + 1)! (N - n)!) = 1, 1/2, 1/10, scaled so that
trace(A^T A) = L (a diffuse field keeps its energy over the sectors).

Departures from the published description, each the program's too:

* the lossless sub-FDN terms (the normalization and the colorless loss) skip
  the DC bin (ROADMAP C10): every exp(skew(M)) of odd order has the
  eigenvalue 1, so diag(z^d) - exp(skew(M)) is singular at z = 1;
* :func:`band_response` leaves out the filterbank's division by the sum of
  its bands' magnitudes: around an interior band the crossfades of its
  neighbours and its own sum to 1, so the division is by 1 to rounding.

Float32 matrix products follow ``torch.backends.cuda.matmul.allow_tf32``,
which this module sets False when it is imported (the control sets it True
for its own run).
"""

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import gfdn as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CARDIOID_ORDER_2 = (1.0, 0.5, 0.1)  # max-directivity order weights, N = 2
WEIGHT_NORM_EPS = 1e-6


def unit_vectors(directions: np.ndarray) -> np.ndarray:
    """(J, 3) Cartesian unit vectors of (2, J) (azimuth, elevation) in radians."""
    azi, ele = np.asarray(directions, np.float64)
    return np.stack([np.cos(ele) * np.cos(azi), np.cos(ele) * np.sin(azi), np.sin(ele)], -1)


def sh_order_2(xyz: np.ndarray) -> np.ndarray:
    """(J, 9) real SH of order 2 at unit vectors (J, 3): ACN, orthonormal, no
    Condon-Shortley phase."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    c0 = 0.5 / math.sqrt(math.pi)
    c1 = math.sqrt(3.0 / (4.0 * math.pi))
    c2 = 0.5 * math.sqrt(15.0 / math.pi)
    c20 = 0.25 * math.sqrt(5.0 / math.pi)
    c22 = 0.25 * math.sqrt(15.0 / math.pi)
    return np.stack([np.full_like(x, c0), c1 * y, c1 * z, c1 * x,
                     c2 * x * y, c2 * y * z, c20 * (3.0 * z * z - 1.0), c2 * x * z,
                     c22 * (x * x - y * y)], axis=-1)


def analysis_matrix(directions: np.ndarray, order_weights=CARDIOID_ORDER_2) -> np.ndarray:
    """(J, 9) float32 analysis matrix steered to ``directions``: the SH basis
    times the order weights (max-directivity by default), energy-scaled."""
    weights = np.repeat(np.asarray(order_weights), [1, 3, 5])
    a = sh_order_2(unit_vectors(directions)) * weights[None, :]
    return (a * math.sqrt(a.shape[1] / np.trace(a.T @ a))).astype(np.float32)


def band_response(cfg: dict, nfft: int) -> np.ndarray:
    """(nfft / 2 + 1,) complex128: the subband filter of the configuration's
    ``subband_process_config`` on the rFFT grid. The amplitude-preserving
    linear-phase FIR bank of 1/b-octave bands (base 10, b odd): the band of
    exact centre 1000 G^(k / b) (G = 10^0.3) nearest the centre frequency,
    its magnitude sin^2 crossfades, half an octave / b wide in log2
    frequency, at its edges centre / G^(1 / 2b) and centre G^(1 / 2b); a
    delay of half the FIR's min(4096, nfft) taps; the FIR's rFFT at nfft."""
    sb = cfg["trainer_config"]["subband_process_config"]
    fs = float(cfg["sample_rate"])
    b = int(sb["num_fraction_octaves"])
    if b % 2 == 0 or not sb.get("use_amp_preserving_filterbank", True):
        raise ValueError("the reference holds the amplitude-preserving bank of odd 1/b octaves")
    g = 10.0 ** 0.3
    centre = 1000.0 * g ** (round(b * math.log(sb["centre_frequency"] / 1000.0, g)) / b)
    half = g ** (1.0 / (2.0 * b))
    n_fir = min(2 ** 12, nfft)
    freqs = np.fft.rfftfreq(n_fir, d=1.0 / fs)
    log_f = np.log2(np.maximum(freqs, 1e-12))
    width = 0.5 / b

    def ramp_up(edge):
        x = np.clip((log_f - (math.log2(edge) - width / 2.0)) / width, 0.0, 1.0)
        return np.sin(0.5 * np.pi * x) ** 2

    mag = ramp_up(centre / half) * (1.0 - ramp_up(centre * half))
    phase = np.exp(-2j * np.pi * freqs * (n_fir // 2) / fs)
    return np.fft.rfft(np.fft.irfft(mag * phase, n=n_fir), n=nfft)


def decay_envelopes(decay_times: np.ndarray, length: int, fs: float) -> np.ndarray:
    """(K, length) float32 unit-norm envelopes exp(-t ln(10^6) / T_k), in
    float32 as the configuration computes them."""
    t = (np.arange(length) / fs).astype(np.float32)
    tk = np.asarray(decay_times, np.float32).reshape(-1)
    env = np.exp(-t[None, :] * (np.float32(math.log(1e6)) / tk[:, None]))
    return env / (np.sqrt(np.sum(env ** 2, axis=1, keepdims=True)) + np.float32(ref.EPS_F32))


class DirectionalGFDN:
    """The SH-domain model of a configuration file's ``preset`` over a grid's
    common decay times (1, G) and directions (2, J), in ``dtype`` (float32 or
    float64) from the configuration's float32 values."""

    def __init__(self, cfg: dict, decay_times: np.ndarray, directions: np.ndarray, device,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.loop = ref.GridGFDN(cfg, decay_times, None, device, dtype)
        self.real, self.cplx = self.loop.real, self.loop.cplx
        self.g, self.nper = self.loop.g, self.loop.nper
        fs = float(cfg["sample_rate"])
        t60 = float(np.max(decay_times))
        self.nfft = 2 ** int(math.ceil(math.log2(t60 * fs)))  # the dataset's grid
        self.mixing = int(20.0 * 1e-3 * fs)
        self.edc_len = min(int(t60 * 1e3 * 1e-3 * fs) + self.mixing, self.nfft) - self.mixing
        out = cfg["output_filter_config"]
        self.num_features = int(out["num_fourier_features"])
        self.blocks = int(out["num_hidden_layers"])
        self.analysis = torch.as_tensor(analysis_matrix(directions), device=device).to(dtype)
        self.band = torch.as_tensor(band_response(cfg, self.nfft).astype(np.complex64),
                                    device=device).to(self.cplx)
        self.envelopes = torch.as_tensor(decay_envelopes(
            np.asarray(decay_times).reshape(-1)[: self.g], int(t60 * 1e3 * 1e-3 * fs), fs),
            device=device).to(dtype)

    def sh_weights(self, p: Dict[str, torch.Tensor], norm_pos: torch.Tensor) -> torch.Tensor:
        """(B, G, L): each group's unit-norm SH weights times its output gains."""
        pre = "sh_output_scalars.skip_mlp."

        def layer(x, name):
            x = torch.nn.functional.linear(x, p[f"{pre}{name}dense.0.weight"],
                                           p[f"{pre}{name}dense.0.bias"])
            x = torch.nn.functional.layer_norm(x, x.shape[-1:], p[f"{pre}{name}norm.0.weight"],
                                               p[f"{pre}{name}norm.0.bias"], ref.LAYER_NORM_EPS)
            return torch.relu(x)

        x = layer(ref.fourier_features(norm_pos, self.num_features), "")
        for i in range(self.blocks):
            x = layer(x, f"blocks.{i}.") + x
        w = torch.nn.functional.linear(x, p[f"{pre}dense.1.weight"], p[f"{pre}dense.1.bias"])
        w = w.reshape(norm_pos.shape[0], self.g, self.nper)
        w = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + WEIGHT_NORM_EPS)
        return w * p["output_gains"].reshape(self.g, self.nper)[None]

    def drive(self, p, z: torch.Tensor) -> torch.Tensor:
        """(G, F, L): q_g = M_g(z)^-T b_g."""
        blocks = self.loop.loop_blocks(p, z).transpose(-1, -2)
        rhs = p["input_gains"].reshape(self.g, 1, self.nper, 1).to(self.cplx).expand(
            self.g, z.shape[0], self.nper, 1)
        return torch.linalg.solve(blocks, rhs)[..., 0]

    def sh_response(self, p, z: torch.Tensor, norm_pos: torch.Tensor) -> torch.Tensor:
        """(B, L, F) complex SH-domain responses at the receivers (no band)."""
        w = self.sh_weights(p, norm_pos).to(self.cplx)
        return torch.einsum("bgl,gfl->blf", w, self.drive(p, z))

    def response(self, p, z: torch.Tensor, norm_pos: torch.Tensor) -> torch.Tensor:
        """(B, L, F): the SH responses through the band filter, as the loss takes them."""
        return self.sh_response(p, z, norm_pos) * self.band

    def edc_error(self, h: torch.Tensor, amps: torch.Tensor, mask: Optional[torch.Tensor],
                  analysis: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The mean |dB| error of the directional EDCs of SH responses h
        (B, L, F) against the amplitudes (B, J, K) times the envelopes, over
        the EDC mask when given; ``analysis`` (J, L), the directions' rows of
        the analysis matrix (default: all)."""
        rir = torch.fft.irfft(h, self.nfft, dim=-1)[..., self.mixing:self.mixing + self.edc_len]
        beams = self.analysis if analysis is None else analysis
        edc = ref.backward_energy(torch.matmul(beams, rir))  # (B, J, T)
        target = torch.matmul(amps, self.envelopes[:, : edc.shape[-1]])
        err = torch.abs(ref.db(target) - ref.db(edc))
        if mask is None:
            return torch.mean(err)
        return torch.sum(err * mask) / (torch.sum(mask) * (err.numel() // err.shape[-1]) + 1e-9)

    def losses(self, p, h: torch.Tensor, amps: torch.Tensor, mask: Optional[torch.Tensor],
               z_sub: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The weighted losses of SH responses h (B, L, F) (band included)
        against the amplitudes (B, J, K); ``z_sub``: the sub-FDNs' bins."""
        tc = self.cfg["trainer_config"]
        out = {"edc_loss": tc["edc_loss_weight"] * self.edc_error(h, amps, mask)}
        out.update(self.colorless_losses(p, z_sub))
        return out

    def colorless_losses(self, p, z_sub: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The weighted spectral and sparsity terms of the lossless sub-FDNs
        at ``z_sub`` (none without the colorless loss)."""
        tc = self.cfg["trainer_config"]
        out = {}
        if tc.get("use_colorless_loss", False):
            h_sub = torch.abs(self.loop.sub_outputs(p, z_sub))
            diff = torch.abs(h_sub - 1.0)
            if tc.get("use_asym_spectral_loss", False):
                terms = diff ** (2.0 + 2.0 * ((h_sub - 1.0) > 1.0).to(diff.dtype))
            else:
                terms = diff ** 2
            out["spectral_loss"] = tc["spectral_loss_weight"] * torch.sum(torch.mean(terms, 0))
            last = ref.skew_exp(p["feedback_loop.M"])[-1]
            n = last.shape[-1]
            out["sparsity_loss"] = tc["sparsity_loss_weight"] * (
                -(torch.sum(torch.abs(last)) - n * math.sqrt(n)) / (n * (math.sqrt(n) - 1.0)))
        return out

    def norm_scales(self, p, z_sub: torch.Tensor) -> torch.Tensor:
        """Each group's io-gain normalization scale, (G,), over ``z_sub``."""
        return self.loop.norm_scales(p, z_sub)

    def normalize(self, p, z_sub: torch.Tensor) -> torch.Tensor:
        """Divide each group's b and c by :meth:`norm_scales`, in place; the scales."""
        return self.loop.normalize(p, z_sub)
