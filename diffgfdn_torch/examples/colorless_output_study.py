"""Does colorless pre-training flatten each group's magnitude response?

Port of ``examples/colorless_output_study.py`` (the reference's
``notebooks/investigate_colorless_output.ipynb``): for each room group,
train a lossless prototype FDN so that |H| -> 1 and compare the initial and
final magnitude responses: the SPECTRAL FLATNESS should rise and the
spectral MSE against |H| = 1 should drop.

One :class:`~diffgfdn_torch.models.colorless.ColorlessFDN` per group trains
through the port's ``ColorlessFDNTrainer`` on ``device`` (its dense loop
inverse and its gradient are the Gauss-Jordan kernels on CUDA tensors).
:func:`train_groups` returns the numbers and responses,
:func:`draw_responses` plots them, :func:`run` does both.

Run: python -m diffgfdn_torch.examples.colorless_output_study [--out /tmp/colorless]
     [--epochs 6] [--device cpu]
"""

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config.schema import ColorlessFDNConfig
from ..models.colorless import ColorlessFDN
from ..ops.basic import db, spectral_flatness
from ..training.colorless_trainer import ColorlessFDNTrainer
from ..utils.device import resolve_device
from ..utils.params import load_jax_params

Device = Union[str, torch.device]

# per-group co-prime delay sets (three "rooms", 4 lines each)
GROUP_DELAYS = (
    (163, 179, 191, 211),
    (223, 227, 233, 239),
    (251, 257, 263, 269),
)
NUM_EVAL = 2048


def train_groups(out_dir="/tmp/colorless", fs=8000.0, epochs=6, seed=0, device: Device = "cuda",
                 params: Optional[List[Dict]] = None) -> List[Dict]:
    """Train one prototype per group (checkpoints under ``out_dir/group<g>``);
    each group's {"flat0", "flat1", "mse0", "mse1", "h0", "h1"}: the spectral
    flatness of |H| in dB and the MSE of |H| against 1, before and after,
    and the magnitudes at 2048 bins. Group g's model draws its parameters
    from a ``torch.Generator`` seeded ``seed + g``; ``params``: the groups'
    JAX parameter trees (numpy) instead."""
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ccfg = ColorlessFDNConfig(use_colorless_prototype=True, max_epochs=epochs, batch_size=256,
                              lr=0.02)
    z = torch.as_tensor(np.exp(1j * np.linspace(0.0, np.pi, NUM_EVAL, endpoint=False)
                               ).astype(np.complex64), device=dev)
    results = []
    for g, delays in enumerate(GROUP_DELAYS):
        model = ColorlessFDN(sample_rate=fs, delays=delays,
                             generator=torch.Generator().manual_seed(seed + g))
        if params is not None:
            load_jax_params(model, params[g])
        model = model.to(dev)

        def resp():
            with torch.no_grad():
                return torch.abs(model(z)[0])

        h0 = resp()
        trainer = ColorlessFDNTrainer(model, ccfg, str(out / f"group{g}"), device=dev)
        model = trainer.fit(num_freq_samples=1024, seed=seed + g)
        h1 = resp()
        h0_np, h1_np = h0.cpu().numpy(), h1.cpu().numpy()
        results.append(dict(
            flat0=spectral_flatness(db(h0).cpu().numpy()),
            flat1=spectral_flatness(db(h1).cpu().numpy()),
            mse0=float(np.mean((h0_np - 1.0) ** 2)),
            mse1=float(np.mean((h1_np - 1.0) ** 2)),
            h0=h0_np, h1=h1_np,
        ))
    return results


def draw_responses(results: List[Dict], out: Path, fs=8000.0) -> None:
    """``colorless_responses.png``: each group's |H| in dB before and after
    (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(results), 1, figsize=(8, 9), sharex=True)
    freqs = np.linspace(0, fs / 2, NUM_EVAL)
    for g, r in enumerate(results):
        for h, style, label in ((r["h0"], "--", f"init (flatness {r['flat0']:.3f})"),
                                (r["h1"], "-", f"trained (flatness {r['flat1']:.3f})")):
            axes[g].semilogx(freqs[1:], 20.0 * np.log10(h[1:] + np.finfo(np.float32).eps),
                             style, label=label)
        axes[g].set_ylabel(f"group {g + 1} |H| [dB]")
        axes[g].legend()
        axes[g].grid(alpha=0.3)
    axes[-1].set_xlabel("frequency [Hz]")
    fig.tight_layout()
    fig.savefig(out / "colorless_responses.png", dpi=120)
    plt.close(fig)


def run(out_dir="/tmp/colorless", fs=8000.0, epochs=6, seed=0, device: Device = "cuda"):
    results = train_groups(out_dir, fs, epochs, seed, device)
    draw_responses(results, Path(out_dir), fs)
    for g, r in enumerate(results):
        print(f"group {g + 1}: spectral flatness {r['flat0']:.3f} -> {r['flat1']:.3f}, "
              f"spectral MSE {r['mse0']:.4f} -> {r['mse1']:.4f}")
    return [{k: r[k] for k in ("flat0", "flat1", "mse0", "mse1")} for r in results]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Colorless pre-training flattens each group")
    parser.add_argument("--out", default="/tmp/colorless")
    parser.add_argument("--epochs", type=int, default=6)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run(args.out, epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    main()
