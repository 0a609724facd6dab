"""Loss surfaces over the (g_in, g_out) IO-gain plane of a 1-group FDN.

Port of ``examples/loss_surface.py`` (the reference's
``notebooks/investigate_loss_surface.ipynb``): for a single-group GFDN,
sweep scalar input/output gains, evaluate each training loss on the grid,
and plot the surfaces. With uniform scalar IO gains the transfer function
depends on the gains only through the PRODUCT ``g_in * g_out``: every loss
has a degenerate valley along the hyperbola ``g_in * g_out = const`` (and
its mirror image), so only the product is identifiable.

The loop response is computed once on ``device`` (the feedback loop's
per-bin inverse is the Gauss-Jordan kernel on CUDA tensors), and the whole
grid is one batched tensor program (``torch.func.vmap``) over the flattened
(g_in, g_out) pairs: 41 x 41 = 1681 loss evaluations in one call.
:func:`compute_surfaces` returns the surfaces, :func:`draw_surfaces` plots
them, :func:`main` does both.

Run: python -m diffgfdn_torch.examples.loss_surface [--out /tmp/loss_surface.png]
     [--grid 41] [--nfft 8192] [--device cpu]
"""

import argparse
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..losses.gfdn import edc_loss, edr_loss
from ..models.feedback_loop import FeedbackLoop
from ..ops.absorption import decay_times_to_gain_per_sample
from ..utils.device import resolve_device
from ..utils.params import load_jax_params

Device = Union[str, torch.device]

DELAYS = (233, 311, 421, 461, 587, 613)


def study_loop(fs: float, t60: float, seed: int = 0, params: Optional[Dict] = None) -> FeedbackLoop:
    """The study's 6-line, 1-group feedback loop (CPU), its parameters drawn
    from a ``torch.Generator`` seeded ``seed``, or ``params`` (a JAX
    parameter tree as numpy) loaded into it."""
    gains = np.asarray(decay_times_to_gain_per_sample(t60, np.asarray(DELAYS), fs))
    loop = FeedbackLoop(num_groups=1, num_delay_lines_per_group=len(DELAYS), delays=DELAYS,
                        gains=gains, generator=torch.Generator().manual_seed(seed))
    if params is not None:
        load_jax_params(loop, params)
    return loop


def compute_surfaces(nfft=8192, grid=41, fs=16000.0, t60=0.25, span=1.5,
                     device: Device = "cuda", params: Optional[Dict] = None):
    """Return (g, edc_surface, edr_surface, target_product).

    ``g``: the (grid,) gain axis; surfaces are (grid, grid) with g_in on
    axis 0 and g_out on axis 1. ``params``: the loop's JAX parameter tree
    (numpy) instead of the seeded draw.
    """
    dev = resolve_device(device)
    loop = study_loop(fs, t60, params=params).to(dev)
    f = nfft // 2 + 1
    z = torch.as_tensor(np.exp(1j * np.linspace(0.0, np.pi, f)).astype(np.complex64),
                        device=dev)
    g_in_true, g_out_true = 0.7, 0.5
    win = 512
    mix = int(0.005 * fs)
    g = np.linspace(-span, span, grid, dtype=np.float32)
    pairs = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    with torch.no_grad():
        # uniform unit IO vectors: H0[f] = 1^T P(z) 1; any scalar pair then
        # gives H = g_in * g_out * H0
        h0 = torch.sum(loop(z), dim=(1, 2))
        h_target = (g_in_true * g_out_true) * h0

        def losses(pair):
            h = (pair[0] * pair[1]) * h0
            return torch.stack([
                edc_loss(h_target, h, mix, nfft),
                edr_loss(h_target, h, win_size=win, hop_size=win // 2),
            ])

        vals = torch.func.vmap(losses)(torch.as_tensor(pairs, device=dev))
    vals = vals.cpu().numpy().reshape(grid, grid, 2)
    return g, vals[..., 0], vals[..., 1], g_in_true * g_out_true


def draw_surfaces(g, edc, edr, prod, out: str) -> None:
    """The EDC and EDR surfaces and the EDC's log contour with the
    degenerate valley (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(13, 4))
    gin, gout = np.meshgrid(g, g, indexing="ij")
    for i, (surf, name) in enumerate([(edc, "EDC loss"), (edr, "EDR loss")]):
        ax = fig.add_subplot(1, 3, i + 1, projection="3d")
        ax.plot_surface(gin, gout, surf, cmap="viridis", linewidth=0)
        ax.set_xlabel("$g_{in}$")
        ax.set_ylabel("$g_{out}$")
        ax.set_title(name)
    ax = fig.add_subplot(1, 3, 3)
    c = ax.contourf(gin, gout, np.log10(edc + 1e-9), levels=25)
    hyp = np.linspace(prod / 1.5, 1.5, 200)
    for s in (1.0, -1.0):
        ax.plot(s * hyp, s * prod / hyp, "r--", lw=1,
                label="$g_{in} g_{out} = g^*$" if s > 0 else None)
    ax.set_xlim(g[0], g[-1])
    ax.set_ylim(g[0], g[-1])
    ax.legend(loc="lower left", fontsize=8)
    ax.set_title("log10 EDC loss + degenerate valley")
    fig.colorbar(c, ax=ax)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Loss surfaces over the IO-gain plane")
    ap.add_argument("--out", default="/tmp/loss_surface.png")
    ap.add_argument("--grid", type=int, default=41)
    ap.add_argument("--nfft", type=int, default=8192)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    g, edc, edr, prod = compute_surfaces(nfft=args.nfft, grid=args.grid, device=args.device)
    draw_surfaces(g, edc, edr, prod, args.out)
    print(f"saved {args.out}")
    i, j = np.unravel_index(np.argmin(edc), edc.shape)
    print(f"EDC-loss minimum at g_in={g[i]:.3f}, g_out={g[j]:.3f} "
          f"(product {g[i] * g[j]:.3f}, true product {prod:.3f})")


if __name__ == "__main__":
    main()
