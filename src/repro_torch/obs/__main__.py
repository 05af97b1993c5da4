"""Trace validator CLI (the reference package's ``python -m repro.obs``).

    PYTHONPATH=src python -m repro_torch.obs TRACE.json \
        --min-coverage 0.95 --expect-span sweep=2 --expect-span mode

Loads a Chrome-trace JSON (``launch.decompose --trace-out`` /
``CPSolver.dump_trace``) and schema-checks it: all ``ph`` B/E events
paired, sibling spans monotone and non-overlapping, children inside
parents, top-level span coverage ≥ the threshold. ``--expect-span
NAME[=COUNT]`` additionally requires the named stage to appear (exactly
COUNT times when given). Exit 0 clean, 1 on any problem.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import validate_trace_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate an exported Chrome-trace JSON")
    ap.add_argument("trace", help="trace file (--trace-out output)")
    ap.add_argument("--min-coverage", type=float, default=0.95,
                    help="required top-level span fraction of wall time")
    ap.add_argument("--expect-span", action="append", default=[],
                    metavar="NAME[=COUNT]",
                    help="require span NAME present (COUNT times if given; "
                         "repeatable)")
    args = ap.parse_args(argv)

    result = validate_trace_file(args.trace,
                                 min_coverage=args.min_coverage)
    problems = list(result["problems"])
    counts = result["span_counts"]
    for spec in args.expect_span:
        name, _, want = spec.partition("=")
        got = counts.get(name, 0)
        if want:
            if got != int(want):
                problems.append(f"span {name!r}: {got} occurrences, "
                                f"expected {want}")
        elif got == 0:
            problems.append(f"span {name!r}: absent from trace")
    for p in problems:
        print(f"TRACE PROBLEM: {p}")
    stages = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"trace: wall {result['wall_us'] / 1e3:.1f} ms, coverage "
          f"{result['coverage']:.1%}, spans [{stages}] — "
          f"{len(problems)} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
