#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` profiles a window of
the traffic's ``trace_units`` and reads the per-layer metrics. Either way
the window's outputs are then judged against the plain reference. The last
line of standard output is the result (JSON); the numbers compared, each
beside its limit, are the last lines of standard error.

Exits non-zero, with no result, without CUDA or with fewer cards than the
cell asks for, and when the process holds a JAX module after the window.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "diffgfdn_tpu")  # top-level module names


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is a JAX one."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((c for c in spec["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload named {args.workload}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark.lib import cell as harness, port

    t0 = time.perf_counter()
    port.build_kernels()
    built_s = time.perf_counter() - t0
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", STARTED)
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"kernels found or built in {built_s:.3f} s, {t0 - STARTED:.3f} s after the start",
          file=sys.stderr)
    for name, row in result["checks"].items():
        ok = row["value"] is not None and row["value"] <= row["limit"]
        print(f"check {name} {row['value']!r} limit {row['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
