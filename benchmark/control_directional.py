#!/usr/bin/env python3
"""The readings that the ``directional-train`` cell's limits are set from, at
the cell's own size.

    python3 benchmark/control_directional.py --seeds <n> [<n> ...]
    python3 benchmark/control_directional.py --program-faults --seeds <n> [<n> ...]

As ``benchmark/control.py`` for the grid cells, with the directional
reference (``benchmark/lib/directional_checks.py``). For each seed, in one
process: the cell's set-up (its probe and its first epoch), then each number
the check compares, against the float32 reference (the normalization against
the float64 one), for

* ``program``: the program (the lower readings);
* ``control``: the reference with TF32 products in the program's place;
* the faults, planted in the reference put in the program's place:
  ``half_batch``, ``frozen``, ``norm_skipped`` (as the grid cells') and each
  of ``directional_checks.FAULTS``;
* the float64 witness: ``program_f64`` and ``reference_f64``.

One JSON line a seed on standard output, with each leaf's gradient gap and
each step's losses. With ``--program-faults``, instead: each fault of
:data:`PROGRAM_FAULTS` planted in the program itself, a whole set-up and
check each, one JSON line a fault and seed with its numbers and whether the
run reads ``correct``. Needs a CUDA card.
"""

import argparse
import contextlib
import gc
import json
from pathlib import Path
import sys

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "directional-train"


@contextlib.contextmanager
def program_fault(name: str):
    """One fault planted in the program: B6 returning twice M^-H g
    (``b6_x2``), B2 twice -P^H G P^H (``b2_x2``), the analysis matrix's rows
    rolled by one direction (``permuted``), the sparsity term doubled
    (``sparsity_x2``)."""
    import numpy as np

    from diffgfdn_torch.kernels import cinv, lu
    from diffgfdn_torch.training import build, trainer

    if name == "b6_x2":
        module, attr = lu, "lut_apply"
        orig = lu.lut_apply
        patched = lambda f, piv, g: 2.0 * orig(f, piv, g)  # noqa: E731
    elif name == "b2_x2":
        module, attr = cinv, "neg_ptgpt"
        orig = cinv.neg_ptgpt
        patched = lambda p, g: 2.0 * orig(p, g)  # noqa: E731
    elif name == "permuted":
        module, attr = build, "build_analysis_matrix"
        orig = build.build_analysis_matrix
        patched = lambda order, directions, bf: np.roll(  # noqa: E731
            np.asarray(orig(order, directions, bf)), 1, axis=0)
    elif name == "sparsity_x2":
        module, attr = trainer, "sparsity_loss"
        orig = trainer.sparsity_loss
        patched = lambda x: 2.0 * orig(x)  # noqa: E731
    else:
        raise ValueError(f"no program fault named {name}")
    patched.__dict__.update(orig.__dict__)  # the wrapper's launch counter
    setattr(module, attr, patched)
    try:
        yield
    finally:
        setattr(module, attr, orig)


PROGRAM_FAULTS = ("b6_x2", "b2_x2", "permuted", "sparsity_x2")


def training_readings(run) -> dict:
    import numpy as np
    import torch

    from benchmark.control import tf32
    from benchmark.lib import checks, directional_checks as dc

    st, r = run.state, run.readings
    f32 = torch.float32
    follow_m = dc.program_m(r)
    args = (run.preset, st["grid"], st["weights"], r["batches"], run.seed, run.device)
    valid = (run.preset, st["grid"], r, run.seed, run.device)
    states = (run.preset, st["grid"], r["norm_states"], run.device)
    pr = r["probe"]
    probe = (run.preset, st["grid"], st["weights"], pr["batch"], pr["mask"], run.device)

    def training(**kw):
        return dc.DirectionalTraining(*args, follow_m=follow_m, **kw).run()

    def completed(out, scales, valid_loss, probe_side):
        out["scales"], out["valid_loss"], out["probe"] = scales, valid_loss, probe_side
        return out

    def numbers(prog, reference):
        return {**checks.training_numbers(prog, reference),
                **dc.probe_numbers(prog["probe"], reference["probe"])}

    follow = r["normalized"]
    ref_probe = dc.reference_probe(*probe)
    reference = completed(training(follow=follow), dc.reference_scales(*states),
                          dc.reference_valid_loss(*valid), ref_probe)
    f64 = completed(training(dtype=torch.float64, follow=follow), reference["scales"],
                    dc.reference_valid_loss(*valid, dtype=torch.float64),
                    dc.reference_probe(*probe, dtype=torch.float64))
    ref32 = dict(reference, scales=dc.reference_scales(*states, dtype=f32))
    tf32(True)
    control = completed(training(), dc.reference_scales(*states, dtype=f32),
                        dc.reference_valid_loss(*valid), dc.reference_probe(*probe))
    tf32(False)
    # the reference, following the control's own normalized gains
    control_ref = completed(training(follow=control["normalized"]), reference["scales"],
                            reference["valid_loss"], ref_probe)
    out = {"program": numbers(dict(r, probe=pr), reference),
           "control": numbers(control, control_ref)}
    half = completed(training(keep=0.5, follow=follow), ref32["scales"],
                     dc.reference_valid_loss(*valid, keep=0.5),
                     dc.reference_probe(*probe, keep=0.5))
    out["half_batch"] = numbers(half, reference)
    frozen = completed(training(frozen=True, follow=follow), ref32["scales"],
                       reference["valid_loss"], ref_probe)
    out["frozen"] = numbers(frozen, reference)
    out["norm_skipped"] = {"norm_gap": float(max(np.max(np.abs(1.0 - s) / s)
                                                 for s in reference["scales"]))}
    for fault in dc.FAULTS:
        planted = completed(training(fault=fault, follow=follow), ref32["scales"],
                            dc.reference_valid_loss(*valid, fault=fault),
                            dc.reference_probe(*probe, fault=fault))
        out[fault] = numbers(planted, reference)
    out["program_f64"] = numbers(dict(r, probe=pr), f64)
    out["reference_f64"] = numbers(ref32, f64)

    def leaves(side, against):
        return checks.leaf_gaps(side["grad_norms"], against["grad_norms"])

    out.update(
        grad_leaves={"program": leaves(r, reference), "control": leaves(control, control_ref),
                     "program_f64": leaves(r, f64)},
        reached=reference["reached"],
        parts={"program": r["parts"], "reference": reference["parts"], "f64": f64["parts"]},
        scales={"program": [s.tolist() for s in r["scales"]],
                "f64": [s.tolist() for s in reference["scales"]]})
    return out


def fault_readings(seed: int, fault: str) -> dict:
    """The cell's set-up and check with ``fault`` planted in the program."""
    import torch

    from benchmark.lib import cell as harness, checks

    run, loop = harness.prepare(WORKLOAD, seed, "cuda")
    with program_fault(fault):
        loop.setup(run)
    loop.release(run)
    gc.collect()
    torch.cuda.empty_cache()
    numbers = loop.check(run)
    correct, _ = checks.judged(numbers, run.limits)
    return {"workload": WORKLOAD, "seed": seed, "program_fault": fault, "correct": correct,
            "numbers": numbers}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-faults", action="store_true",
                    help="plant each of PROGRAM_FAULTS in the program instead")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from benchmark.control import tf32

    tf32(False)
    from benchmark.lib import cell as harness, port

    port.build_kernels()
    for seed in args.seeds:
        if args.program_faults:
            for fault in PROGRAM_FAULTS:
                print(json.dumps(fault_readings(seed, fault)), flush=True)
                gc.collect()
                torch.cuda.empty_cache()
            continue
        run, loop = harness.prepare(WORKLOAD, seed, "cuda")
        loop.setup(run)
        loop.release(run)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": WORKLOAD, "seed": seed, **training_readings(run)}),
              flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
