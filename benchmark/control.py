#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up (its first epoch), then
each number the check compares, against the float32 reference (the
normalization against the float64 one), for

* ``program``: the program (the lower readings);
* ``control``: the reference with TF32 products (the nearest precision below
  the configuration's float32 with TF32 off) in the program's place;
* the faults, planted in the reference put in the program's place:
  ``half_batch`` (each batch's second half left out, the mean taken over
  the rest), ``frozen`` (every step returns the state unchanged) and
  ``norm_skipped`` (the normalization returns the gains unchanged);
* the float64 witness: ``program_f64`` and ``reference_f64``, the program's
  and the float32 reference's numbers against the reference in float64
  (which side a gap comes from).

One JSON line a seed on standard output, with each leaf's gradient gap and
each step's losses. Needs a CUDA card.
"""

import argparse
import gc
import json
from pathlib import Path
import sys

ROOT = Path(__file__).resolve().parents[1]


def tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def training_readings(run) -> dict:
    import numpy as np
    import torch

    from benchmark.lib import checks

    st, r = run.state, run.readings
    f32 = torch.float32
    args = (run.preset, st["grid"], st["weights"], r["batches"], run.seed, run.device)
    valid = (run.preset, st["grid"], r, run.seed, run.device)
    states = (run.preset, st["grid"], r["norm_states"], run.device)

    def completed(out, scales, valid_loss):
        out["scales"], out["valid_loss"] = scales, valid_loss
        return out

    reference = completed(checks.ReferenceTraining(*args, follow=r["normalized"]).run(),
                          checks.reference_scales(*states), checks.reference_valid_loss(*valid))
    f64 = completed(checks.ReferenceTraining(*args, dtype=torch.float64,
                                             follow=r["normalized"]).run(),
                    reference["scales"], checks.reference_valid_loss(*valid, dtype=torch.float64))
    ref32 = dict(reference, scales=checks.reference_scales(*states, dtype=f32))
    tf32(True)
    control = completed(checks.ReferenceTraining(*args).run(),
                        checks.reference_scales(*states, dtype=f32),
                        checks.reference_valid_loss(*valid))
    tf32(False)
    # the reference, following the control's own normalized gains
    control_ref = completed(checks.ReferenceTraining(*args, follow=control["normalized"]).run(),
                            reference["scales"], reference["valid_loss"])
    half = completed(checks.ReferenceTraining(*args, keep=0.5, follow=r["normalized"]).run(),
                     ref32["scales"], checks.reference_valid_loss(*valid, keep=0.5))
    frozen = completed(checks.ReferenceTraining(*args, frozen=True, follow=r["normalized"]).run(),
                       ref32["scales"], reference["valid_loss"])
    skipped = float(max(np.max(np.abs(1.0 - s) / s) for s in reference["scales"]))

    def leaves(out, against):
        return checks.leaf_gaps(out["grad_norms"], against["grad_norms"])

    return {"program": checks.training_numbers(r, reference),
            "control": checks.training_numbers(control, control_ref),
            "half_batch": checks.training_numbers(half, reference),
            "frozen": checks.training_numbers(frozen, reference),
            "norm_skipped": {"norm_gap": skipped},
            "program_f64": checks.training_numbers(r, f64),
            "reference_f64": checks.training_numbers(ref32, f64),
            "grad_leaves": {"program": leaves(r, reference),
                            "control": leaves(control, control_ref),
                            "program_f64": leaves(r, f64)},
            "reached": reference["reached"],
            "parts": {"program": r["parts"], "reference": reference["parts"],
                      "f64": f64["parts"]},
            "scales": {"program": [s.tolist() for s in r["scales"]],
                       "f64": [s.tolist() for s in reference["scales"]]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    tf32(False)
    from benchmark.lib import cell as harness, port

    port.build_kernels()
    for seed in args.seeds:
        run, loop = harness.prepare(args.workload, seed, "cuda")
        loop.setup(run)
        loop.release(run)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, **training_readings(run)}),
              flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
