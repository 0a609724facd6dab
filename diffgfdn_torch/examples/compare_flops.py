"""Deployment cost comparison: the reference's ``compare_flops.ipynb``.

Port of ``examples/compare_flops.py``. Prints the per-sample FLOP / memory
cost of every renderer family (:mod:`diffgfdn_torch.utils.flops`, host
arithmetic) and saves a log-scale comparison figure:

* one full-band GFDN with GEQ absorption vs 8 parallel subband GFDNs;
* a directional (SH-domain) grouped FDN vs partitioned convolution of a
  9-channel 2-s SRIR (the "can this run in an audio callback?" question);
* the position-MLP inference cost and parameter footprint.

Run: python -m diffgfdn_torch.examples.compare_flops [--out /tmp/compare_flops.png]
"""

import argparse
from typing import Dict

from ..utils.flops import (
    conv_flops,
    dir_gfdn_flops,
    gfdn_flops,
    gfdn_mems,
    mlp_flops,
    mlp_mems,
)


def cost_table(num_delay_lines: int = 12, num_bands: int = 8) -> Dict:
    """The comparison's numbers: ``rows`` [(renderer, FLOPs/sample)], the
    position MLP's FLOPs per query and parameters, and the GFDN's state
    memory (floats)."""
    n, b = num_delay_lines, num_bands
    return {
        "rows": [
            ("full-band GFDN, GEQ absorption", gfdn_flops(n, b)),
            (f"{b} parallel subband GFDNs", gfdn_flops(n, b, is_parallel=True)),
            ("directional GFDN (order 2, 3 rooms)", dir_gfdn_flops(2, 3, b, 12)),
            ("partitioned conv, 9ch 2s SRIR", conv_flops(9, 2000.0, 512)),
            ("partitioned conv, 9ch 1s SRIR", conv_flops(9, 1000.0, 512)),
        ],
        "mlp_flops": mlp_flops(3, 64, 32),
        "mlp_params": mlp_mems(3, 64, 32),
        "gfdn_mems": gfdn_mems(48000.0, n, 25.0, 3),
    }


def print_table(table: Dict, num_delay_lines: int) -> None:
    print(f"{'renderer':<38} FLOPs/sample")
    for name, v in table["rows"]:
        print(f"{name:<38} {v:>12,.0f}")
    print(
        f"\nposition MLP (3x64, 32 features): {table['mlp_flops']:,} FLOPs/query, "
        f"{table['mlp_params']:,} params"
    )
    print(
        f"GFDN state memory (N={num_delay_lines}, 3 rooms, 25 ms avg delay @48k): "
        f"{table['gfdn_mems']:,} floats"
    )


def draw_costs(table: Dict, out: str) -> None:
    """The log-scale bar chart of the renderers' costs (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = table["rows"]
    fig, ax = plt.subplots(figsize=(7, 3.2))
    ax.barh(range(len(rows)), [r[1] for r in rows], color=["C0", "C0", "C0", "C3", "C3"])
    ax.set_yticks(range(len(rows)))
    ax.set_yticklabels([r[0] for r in rows], fontsize=8)
    ax.set_xscale("log")
    ax.set_xlabel("FLOPs per output sample (log)")
    ax.set_title("Late-reverb renderer cost: GFDN vs partitioned convolution")
    ax.invert_yaxis()
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Renderer FLOP and memory costs")
    ap.add_argument("--out", default="/tmp/compare_flops.png")
    ap.add_argument("--num-delay-lines", type=int, default=12)
    ap.add_argument("--num-bands", type=int, default=8)
    args = ap.parse_args(argv)

    table = cost_table(args.num_delay_lines, args.num_bands)
    print_table(table, args.num_delay_lines)
    draw_costs(table, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
