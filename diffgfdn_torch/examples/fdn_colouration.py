"""Colouration of filtered-and-summed subband GFDNs.

Port of ``examples/fdn_colouration.py`` (the reference's
``notebooks/investigate_fdn_colouration.ipynb``): subband decomposition
trains one GFDN per octave band and reconstructs the full-band RIR as a
filtered sum. How much spectral colouration does each reconstruction add?

1. **Plain sum** of the 8 subband GFDN responses: bands overlap and beat.
2. **Amplitude-preserving filterbank sum** ``sum_b W_b(f) H_b(f)`` with the
   reconstructing fractional-octave bank
   (:func:`~diffgfdn_torch.ops.filterbanks.subband_filter_response`), the
   production reconstruction of subband training and inference.
3. **Time-reversed (dual) filterbank** filtering of the per-band
   time-domain RIRs (:func:`~diffgfdn_torch.ops.filterbanks.time_reversed_filtering`).

Readouts: the **colouration** (std in dB of the detrended summed magnitude
over the passband) and the **per-band decay** (the top band's Schroeder
decay over the window). In the plain sum every band region also receives
the slow low-band FDN's energy, so the top band decays too slowly; the
filtered sums restore its prescribed decay.

The band responses run on ``device`` (one Gauss-Jordan kernel launch per
band on CUDA tensors), the filterbank and readouts on the host.
:func:`band_responses` and :func:`readouts` return the numbers,
:func:`draw_colouration` plots them, :func:`main` does both.

Run: python -m diffgfdn_torch.examples.fdn_colouration [--out /tmp/colouration.png]
     [--nfft 16384] [--device cpu]
"""

import argparse
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..models.feedback_loop import FeedbackLoop
from ..ops.absorption import decay_times_to_gain_per_sample
from ..ops.filterbanks import (
    reconstructing_fractional_octave_bands,
    subband_filter_response,
    time_reversed_filtering,
)
from ..utils.device import resolve_device
from ..utils.params import load_jax_params

Device = Union[str, torch.device]

DELAYS = (241, 311, 379, 433, 509, 587)


def band_responses(nfft=16384, fs=32000.0, seed=0, device: Device = "cuda",
                   params: Optional[List[Dict]] = None):
    """Frequency responses (num_bands, F) of 8 per-band GFDNs + the bank.

    Returns (centres, h_bands, w_bands, t60s), the responses complex numpy.
    Band b's loop draws its parameters from a ``torch.Generator`` seeded
    ``seed + b``; ``params``: the bands' JAX parameter trees (numpy) instead.
    """
    dev = resolve_device(device)
    centres = [62.5 * 2.0 ** k for k in range(8)]
    # a plausible room: T60 falling with frequency (1.2 s at 62.5 Hz down
    # to ~0.28 s at 8 kHz, typical air/material HF absorption)
    t60s = 1.2 * (np.asarray(centres) / 62.5) ** -0.3
    f = nfft // 2 + 1
    z = torch.as_tensor(np.exp(1j * np.linspace(0.0, np.pi, f)).astype(np.complex64),
                        device=dev)
    resps = []
    for b in range(len(centres)):
        gains = np.asarray(decay_times_to_gain_per_sample(t60s[b], np.asarray(DELAYS), fs))
        loop = FeedbackLoop(num_groups=1, num_delay_lines_per_group=len(DELAYS),
                            delays=DELAYS, gains=gains,
                            generator=torch.Generator().manual_seed(seed + b))
        if params is not None:
            load_jax_params(loop, params[b])
        loop = loop.to(dev)
        with torch.no_grad():
            h = torch.sum(loop(z), dim=(1, 2)) / len(DELAYS)
        resps.append(h.cpu().numpy())
    h_bands = np.stack(resps)  # (8, F) complex
    w_bands = np.stack([
        subband_filter_response(fc, (min(centres), max(centres)), 1, fs, nfft)
        for fc in centres
    ])  # (8, F) complex
    return np.asarray(centres), h_bands, w_bands, t60s


def band_decay_db(h, w_band, nfft, fs, t_frac=(0.1, 0.9), undo_delay_samps=0):
    """Schroeder decay (dB) of a band-filtered response over the window.

    ``h``: full-band response (F,) complex; ``w_band``: the band filter
    response (F,), applied ZERO-PHASE (|W|) so the extraction itself adds
    no group delay to the decay measurement. ``undo_delay_samps`` removes
    a known linear-phase delay already inside ``h`` (the reconstruction
    bank's n_samples/2) so the windowed EDC is not shifted/wrapped.
    Returns the dB drop of the band EDC between the two time fractions:
    larger magnitude = faster in-band decay.
    """
    h = np.asarray(h)
    if undo_delay_samps:
        freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
        h = h * np.exp(2j * np.pi * freqs * undo_delay_samps / fs)
    rir = np.fft.irfft(h * np.abs(np.asarray(w_band)), nfft)
    e = np.cumsum(rir[::-1] ** 2)[::-1]
    e = e / (e[0] + 1e-30)
    i0, i1 = int(t_frac[0] * nfft), int(t_frac[1] * nfft)
    return 10.0 * np.log10(e[i1] + 1e-30) - 10.0 * np.log10(e[i0] + 1e-30)


def colouration_db(mag, freqs, lo, hi):
    """Std of the dB magnitude over [lo, hi] Hz (smoothed trend removed)."""
    sel = (freqs >= lo) & (freqs <= hi)
    db = 20.0 * np.log10(np.abs(mag[sel]) + 1e-12)
    # remove the slow trend (octave-scale moving average) so only
    # colouration ripple is scored
    k = max(len(db) // 64, 8)
    trend = np.convolve(db, np.ones(k) / k, mode="same")
    return float(np.std(db - trend))


def readouts(nfft=16384, fs=32000.0, device: Device = "cuda") -> Dict:
    """The three reconstructions' colouration and top-band decay (dB), and
    the top-band GFDN's own decay: {"rows": [(name, response, colouration,
    decay)], "d_ref", "freqs", "lo", "hi"}."""
    centres, h_bands, w_bands, _ = band_responses(nfft, fs, device=device)
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    plain = h_bands.sum(0)
    filtered = (w_bands * h_bands).sum(0)
    # time-reversed dual filterbank on the per-band time-domain RIRs
    rirs = np.fft.irfft(h_bands, nfft, axis=-1).T  # (T, 8)
    coeffs, _ = reconstructing_fractional_octave_bands(
        1, (min(centres), max(centres)), n_samples=2 ** 12, sampling_rate=fs)
    tr = time_reversed_filtering(rirs, coeffs).sum(-1)
    tr_mag = np.fft.rfft(tr[:nfft])
    lo, hi = centres[0], min(centres[-1], fs / 2 * 0.9)
    # linear-phase delays to undo in the decay measurement: the
    # reconstruction FIRs carry n_samples/2 group delay; the time-reversed
    # dual's energy sits at the same offset
    n0 = coeffs.shape[-1] // 2
    w_top = w_bands[-1]
    rows = []
    for name, h, delay in (("plain sum", plain, 0), ("filterbank sum", filtered, n0),
                           ("time-reversed filterbank", tr_mag, n0)):
        rows.append((name, h, colouration_db(h, freqs, lo, hi),
                     band_decay_db(h, w_top, nfft, fs, undo_delay_samps=delay)))
    return {"rows": rows, "d_ref": band_decay_db(h_bands[-1], w_top, nfft, fs),
            "freqs": freqs, "lo": lo, "hi": hi}


def draw_colouration(res: Dict, out: str) -> None:
    """The summed responses' magnitudes, each with its ripple (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    freqs = res["freqs"]
    fig, ax = plt.subplots(figsize=(9, 4.2))
    for name, h, c, _ in res["rows"]:
        ax.semilogx(freqs[1:], 20 * np.log10(np.abs(h[1:]) + 1e-12), lw=0.9,
                    label=f"{name} ({c:.2f} dB ripple)")
    ax.set_xlim(res["lo"] / 1.5, res["hi"] * 1.1)
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("|H| (dB)")
    ax.legend(fontsize=8)
    ax.set_title("summed subband GFDN responses")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Colouration of summed subband GFDNs")
    ap.add_argument("--out", default="/tmp/colouration.png")
    ap.add_argument("--nfft", type=int, default=16384)
    ap.add_argument("--fs", type=float, default=32000.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    res = readouts(args.nfft, args.fs, device=args.device)
    print(f"colouration (dB std of detrended magnitude, {res['lo']:.0f}-{res['hi']:.0f} Hz)"
          " / top-band decay over the window (dB):")
    for name, _, c, d in res["rows"]:
        print(f"  {name:28s} ripple {c:5.2f}   top-band decay {d:7.1f}")
    print(f"  {'(top-band GFDN alone)':28s} {'':14s} top-band decay {res['d_ref']:7.1f}")
    draw_colouration(res, args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
