#!/usr/bin/env python3
"""Where a cell's idle device time goes, by the program's own spans.

    python3 benchmark/tools/program_gaps.py --workload <cell> --seed <n> [--top 10]

from the root of a checkout, on a CUDA card. Makes one ``--trace 1`` run of
the cell through ``benchmark/run.py`` (its result line first), with the
program's spans annotated in the profile, and then prints one JSON line:
the window's busy and wall seconds, the program's spans (``gfdn.*``: count,
total and self ms, the least, median and largest duration), and the longest
idle gaps and the idle seconds by the innermost program span open on the
host when each gap opened (``outside``: none). The annotations cost the
spans some microseconds each, so the run's own per-layer metrics read a
little higher than a plain ``--trace 1`` run's.
"""

import argparse
import contextlib
import json
from pathlib import Path
import sys

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    from benchmark import run as bench
    from benchmark.lib import program_spans, trace as tracing
    from diffgfdn_torch.utils import profiling

    profiled, read, seen = tracing.profiled, tracing.read, {}

    @contextlib.contextmanager
    def annotated():
        profiling.clear()
        with profiling.recording(annotate=True), profiled() as out:
            yield out

    def kept(events):
        seen.update(events=events, spans=profiling.records())
        return read(events)

    tracing.profiled, tracing.read = annotated, kept
    sys.argv = [sys.argv[0], "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", "10", "--trace", "1"]
    rc = bench.main()
    if rc or "events" not in seen:
        return rc or 1
    spans = seen["spans"]
    summary = profiling.summary(spans)
    for name, row in summary.items():
        ns = sorted(s.ns for s in spans if s.name == name)
        row.update(min_ms=ns[0] * 1e-6, median_ms=ns[len(ns) // 2] * 1e-6, max_ms=ns[-1] * 1e-6)
    window = read(seen["events"])
    gaps = program_spans.program_gaps(seen["events"])
    by_label = {}
    for label, sec in gaps:
        by_label[label] = by_label.get(label, 0.0) + sec
    print(json.dumps({
        "workload": args.workload, "window_s": window.window_s, "busy_s": window.busy_s,
        "spans": summary,
        "idle_s_by_span": dict(sorted(by_label.items(), key=lambda kv: -kv[1])),
        "longest_gaps": sorted(gaps, key=lambda g: -g[1])[:args.top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
