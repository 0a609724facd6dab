"""Fade-in behaviour of coupled-room GFDNs.

Port of ``examples/fadein_study.py`` (the reference's
``notebooks/investigate_fadein_behaviour.ipynb``): coupled rooms with no
source-listener line of sight show a FADE-IN, the RIR envelope being a
*difference* of exponentials, rising with the shorter decay rate and falling
with the longer one.

1. The analytic target: ``conv(e^{-d1 t}, e^{-d2 t}) ∝ e^{-d2 t} - e^{-d1 t}``.
2. A 2-group GFDN reproduces it exactly when the group output weights have
   OPPOSITE SIGNS with magnitudes ``1/sqrt(|d2 - d1|)``.
3. Inter-group coupling in the feedback matrix produces the same effect in
   the first echoes.

Every case runs through
:func:`diffgfdn_torch.kernels.tdgfdn.synthesize_rirs_time_domain` (the
time-domain kernel on CUDA tensors), the four cases batched two per call.
:func:`synthesize_cases` returns the RIRs, :func:`draw_fadein` plots the
envelopes, :func:`main` does both.

Run: python -m diffgfdn_torch.examples.fadein_study [--out /tmp/fadein.png] [--fs 16000]
     [--device cpu]
"""

import argparse
from typing import Dict, Union

import numpy as np
import torch

from ..kernels.tdgfdn import synthesize_rirs_time_domain
from ..ops.absorption import decay_times_to_gain_per_sample
from ..ops.unitary import orthogonal_from_skew
from ..utils.device import resolve_device

Device = Union[str, torch.device]

BASE_DELAYS = (31, 43, 57, 73)


def synthesize_cases(fs=16000.0, t60s=(0.25, 0.9), dur_s=0.7, seed=0, device: Device = "cuda"):
    """Return (t, rirs dict, analytic envelope, first-arrival time, u).

    ``u`` is the shared LOSSLESS 4-line kernel: with both groups sharing
    delays and mixing matrix, every synthesized case factors exactly as
    ``sum_g c_g e^{-d_g t} u(t)``; the +/- tap case is the
    difference-of-exponentials fade-in modulating ``u`` sample for sample.
    """
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    # BOTH groups share delays AND mixing matrix: their echo patterns are
    # then sample-coherent and differ only in the per-echo decay, so the
    # +/- tap difference cancels echo by echo at onset. Short delays: the
    # first echo must arrive well BEFORE the fade-in peak (~64 ms here)
    base = BASE_DELAYS
    delays = base + base
    nper = 4
    num = int(dur_s * fs)
    gains = np.concatenate([
        np.asarray(decay_times_to_gain_per_sample(t60s[g], np.asarray(base), fs))
        for g in range(2)
    ]).astype(np.float32)

    # shared orthogonal mixing + scalar coupling Phi kron I (the model's
    # SCALAR coupling structure, models/feedback_loop.py)
    skew = torch.as_tensor(rng.randn(1, nper, nper).astype(np.float32) * 0.5, device=dev)
    block = orthogonal_from_skew(skew)[0].cpu().numpy()
    blocks = np.stack([block, block])

    def coupled(theta):
        phi = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]], np.float32)
        a = np.zeros((8, 8), np.float32)
        for g in range(2):
            for h in range(2):
                a[g * nper:(g + 1) * nper, h * nper:(h + 1) * nper] = phi[g, h] * blocks[h]
        return a

    b_in = np.full(8, 1.0 / np.sqrt(8), np.float32)
    d = 3.0 * np.log(10) / np.asarray(t60s)  # decay rates (1/s)
    w = 1.0 / np.sqrt(abs(d[1] - d[0]))
    c_cases = np.stack([
        np.full(8, 0.35, np.float32),                           # same-sign taps
        np.concatenate([np.full(4, w), np.full(4, -w)]) * 0.2,  # +/- difference
        np.full(8, 0.35, np.float32),                           # same-sign, coupled
        np.concatenate([np.full(4, w), np.full(4, -w)]) * 0.2,  # +/-, coupled
    ]).astype(np.float32)

    def synth(dl, g, a, b, c):
        return synthesize_rirs_time_domain(
            dl, *(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (g, a, b, c)),
            num).cpu().numpy()

    # one batched synthesis per feedback matrix (cases share the core)
    y0 = synth(delays, gains, coupled(0.0), b_in, c_cases[:2])
    yc = synth(delays, gains, coupled(np.pi / 5), b_in, c_cases[2:])
    rirs = {
        "uncoupled, same-sign taps": y0[0],
        "uncoupled, +/- taps": y0[1],
        "coupled (36deg), same-sign taps": yc[0],
        "coupled (36deg), +/- taps": yc[1],
    }
    # the shared lossless kernel (gains = 1) of ONE 4-line group
    u = synth(base, np.ones(nper, np.float32), blocks[0], b_in[:nper],
              np.ones((1, nper), np.float32))[0]

    t = np.arange(num) / fs
    # envelopes start at the first echo (min delay); the analytic target
    # is anchored there too
    t0 = min(delays) / fs
    ts = np.maximum(t - t0, 0.0)
    analytic = np.exp(-d[1] * ts) - np.exp(-d[0] * ts)
    analytic /= analytic.max()
    return t, rirs, analytic, t0, u


def envelope_db(x, win):
    """Moving-RMS envelope in dB, unit peak."""
    e = np.convolve(x ** 2, np.ones(win) / win, mode="same")
    e = np.sqrt(np.maximum(e, 1e-30))
    return 20.0 * np.log10(e / e.max() + 1e-15)


def identity_error(t, rirs: Dict, u, t60s=(0.25, 0.9)) -> float:
    """Max error, over the peak, of the +/- case against the difference of
    exponentials modulating the lossless kernel ``u``."""
    d = 3.0 * np.log(10) / np.asarray(t60s)
    w = 0.2 / np.sqrt(abs(d[1] - d[0]))
    pred = w * (np.exp(-d[0] * t) - np.exp(-d[1] * t)) * u
    got = rirs["uncoupled, +/- taps"]
    return float(np.max(np.abs(got - pred)) / (np.max(np.abs(got)) + 1e-30))


def draw_fadein(t, rirs: Dict, analytic, t0, win: int, out: str) -> None:
    """The four cases' envelopes and the analytic target, whole and in the
    early window (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 4.2))
    for name, rir in rirs.items():
        axes[0].plot(t, envelope_db(rir, win), lw=1.2, label=name)
    axes[0].plot(t, 20 * np.log10(analytic + 1e-15), "k--", lw=1.5,
                 label="analytic $e^{-d_2 t} - e^{-d_1 t}$")
    axes[0].set_ylim(-70, 3)
    axes[0].set_xlabel("time (s)")
    axes[0].set_ylabel("envelope (dB)")
    axes[0].legend(fontsize=7)
    axes[0].set_title("RIR envelopes")
    zoom = t < t0 + 0.12
    for name, rir in rirs.items():
        axes[1].plot(t[zoom], envelope_db(rir, win)[zoom], lw=1.2)
    axes[1].plot(t[zoom], 20 * np.log10(analytic + 1e-15)[zoom], "k--", lw=1.5)
    axes[1].set_xlabel("time (s)")
    axes[1].set_title("early window: fade-in")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fade-in of coupled-room GFDNs")
    ap.add_argument("--out", default="/tmp/fadein.png")
    ap.add_argument("--fs", type=float, default=16000.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    t, rirs, analytic, t0, u = synthesize_cases(fs=args.fs, device=args.device)
    win = int(0.01 * args.fs)
    draw_fadein(t, rirs, analytic, t0, win, args.out)
    print(f"saved {args.out}")
    print(f"difference-of-exponentials identity: max err {identity_error(t, rirs, u):.2e} "
          "of peak (f32 rounding compounds over the recursion)")
    # fade-in vs fade-out: energy-envelope peak time relative to arrival
    for name in ("uncoupled, +/- taps", "uncoupled, same-sign taps"):
        env = envelope_db(rirs[name], win)
        print(f"  {name}: envelope peaks {t[np.argmax(env)] - t0:+.3f} s after first arrival")


if __name__ == "__main__":
    main()
