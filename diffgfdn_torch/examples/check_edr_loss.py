"""Can the EDR loss be computed from DFT bins without an explicit STFT?

Port of ``examples/check_edr_loss.py`` (the reference's
``notebooks/check_edr_loss.ipynb``): the EDR loss needs STFT bins
``H(k, m)`` of the RIR, but training only has the DFT bins ``H(k)``. The
notebook tries the convolution-rule shortcut (modulate the spectrum by
``e^{-j w mR}`` per hop and multiply by the window's DFT) and concludes that
it does not match: multiplying sampled spectra is CIRCULAR time-domain
convolution, so the loss pipeline must irfft to time first, which is what
``losses/gfdn.py``'s ``edr_loss`` does.

:func:`edr_errors` builds both on a synthetic two-slope RIR (the true STFT
through ``ops/stft.py`` on ``device``, the shortcut on the host) and returns
the errors; :func:`draw_edr` saves the two EDRs side by side; :func:`run`
does both.

Run: python -m diffgfdn_torch.examples.check_edr_loss [--out /tmp/check_edr] [--device cpu]
"""

import argparse
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..ops.basic import shaped_wgn
from ..ops.stft import edr_from_stft, stft
from ..utils.device import resolve_device

Device = Union[str, torch.device]


def make_rir(fs=8000.0, dur_s=0.25, decay_times=(0.08, 0.15), seed=0, device: Device = "cuda"):
    """Two-slope shaped-noise RIR + its rFFT (the training-side data); the
    noise is drawn on ``device`` from a ``torch.Generator`` seeded ``seed``."""
    dev = resolve_device(device)
    n = int(dur_s * fs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    amps = torch.tensor([[0.7, 0.3]], dtype=torch.float32, device=dev)
    rir = shaped_wgn(amps, np.asarray(decay_times, np.float32), n, fs, generator=gen)
    rir = rir.cpu().numpy().reshape(-1)
    return rir, np.fft.rfft(rir)


def stft_edr(rir, win_size=512, hop_size=256, device: Device = "cuda"):
    """Ground truth: time-domain STFT -> EDR (dB, (F, T)), the loss path's
    ``ops/stft.py`` on ``device``."""
    dev = resolve_device(device)
    s = stft(torch.as_tensor(np.array(rir, np.float32), device=dev), win_size, hop_size)
    return edr_from_stft(s).cpu().numpy()


def dft_shortcut_edr(response, win_size=512, hop_size=256):
    """The notebook's convolution-rule shortcut, faithfully reproduced (host).

    Per hop m: modulate the rFFT spectrum by e^{-j w m R}, multiply by the
    window's rFFT, keep the first win_size//2+1 bins as that frame's
    "spectrum" (check_edr_loss.ipynb, get_custom_stft_from_dft).
    """
    num_freq_bins = 2 * (len(response) - 1)
    omega = 2.0 * np.pi * np.fft.rfftfreq(num_freq_bins)
    window = np.hanning(win_size + 1)[:-1]  # periodic hann, as the loss path
    wresp = np.fft.rfft(window, num_freq_bins)
    num_windows = (num_freq_bins - win_size) // hop_size + 1
    nbins = win_size // 2 + 1
    frames = np.zeros((num_windows, nbins), np.complex64)
    for m in range(num_windows):
        shifted = response * np.exp(-1j * omega * (m * hop_size))
        frames[m] = (shifted * wresp)[:nbins]
    # backward cumulative energy over frames -> "EDR" (dB), frames on axis -1
    p = np.abs(frames.T) ** 2  # (F, T)
    edr = np.flip(np.cumsum(np.flip(p, axis=-1), axis=-1), axis=-1)
    return 10.0 * np.log10(edr + np.finfo(np.float32).tiny)


def edr_errors(fs=8000.0, device: Device = "cuda", rir: Optional[np.ndarray] = None) -> Dict:
    """The study's numbers: the irfft path's max EDR error and the
    shortcut's mean EDR error (dB), with both EDRs. ``rir``: a given RIR
    instead of :func:`make_rir`'s."""
    dev = resolve_device(device)
    if rir is None:
        rir, response = make_rir(fs=fs, device=dev)
    else:
        rir = np.asarray(rir, np.float32)
        response = np.fft.rfft(rir)
    edr_true = stft_edr(rir, device=dev)
    # the same construction from the irfft'd spectrum: the loss path's
    # irfft(H) -> stft is exact, no shortcut needed
    edr_via_irfft = stft_edr(np.fft.irfft(response, len(rir)), device=dev)
    edr_shortcut = dft_shortcut_edr(response)
    t = min(edr_true.shape[-1], edr_shortcut.shape[-1])
    f = min(edr_true.shape[0], edr_shortcut.shape[0])
    return {
        "err_irfft_db": float(np.max(np.abs(edr_true - edr_via_irfft))),
        "err_shortcut_db": float(np.mean(np.abs(edr_true[:f, :t] - edr_shortcut[:f, :t]))),
        "edr_true": edr_true,
        "edr_shortcut": edr_shortcut[:f, :t],
    }


def draw_edr(res: Dict, out: Path) -> None:
    """``edr_comparison.png``: the true EDR beside the shortcut's (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
    for ax, e, title in (
        (axes[0], res["edr_true"], "EDR from time-domain STFT"),
        (axes[1], res["edr_shortcut"], "EDR from DFT shortcut"),
    ):
        im = ax.imshow(e, aspect="auto", origin="lower", cmap="magma")
        ax.set_title(title)
        ax.set_xlabel("frame")
    axes[0].set_ylabel("frequency bin")
    fig.colorbar(im, ax=axes, label="dB")
    fig.savefig(out / "edr_comparison.png", dpi=120)
    plt.close(fig)


def run(out_dir="/tmp/check_edr", fs=8000.0, device: Device = "cuda"):
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    res = edr_errors(fs=fs, device=dev)
    draw_edr(res, out)
    print(f"irfft->STFT EDR max error:      {res['err_irfft_db']:.2e} dB (exact)")
    print(f"DFT-shortcut EDR mean error:    {res['err_shortcut_db']:.2f} dB (invalid)")
    return {"err_irfft_db": res["err_irfft_db"], "err_shortcut_db": res["err_shortcut_db"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description="EDR from DFT bins vs the true STFT")
    parser.add_argument("--out", default="/tmp/check_edr")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run(args.out, device=args.device)


if __name__ == "__main__":
    main()
