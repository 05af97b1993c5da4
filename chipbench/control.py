"""The control of the comparison that decides ``correct``: on each seed,
a run of the cell whose checked states are also worked out by the
reference in TF32 (the precision below the configuration's float32 with
TF32 off): the window's first sweep from the same entering factors, and
the last mode's update at the run's last state. The control's numbers are
judged against the cell's limits as a run's are, and have to come out not
correct.

    python3 chipbench/control.py --workload amazon-r32.1chip \\
        --seeds 11 12 13 --seconds 10

Prints one JSON line a seed (the program's numbers and verdict, the
control's numbers and verdict), then the largest program reading and the
smallest control reading of each number. Exits non-zero if the control
comes out correct on any seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chipbench import env  # noqa: E402

env.prepare(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from chipbench import check, harness
    program, control, passed = [], [], []
    for seed in args.seeds:
        r = harness.run(args.workload, seed, args.seconds, False,
                        t_start=time.perf_counter(), control=True)
        program.append({k: c["value"] for k, c in r["checks"].items()})
        control.append(r["control"])
        limits = {k: c["limit"] for k, c in r["checks"].items()}
        passed.append(check.judge(control[-1], limits))
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "program": program[-1],
                          "control_correct": passed[-1],
                          "control": control[-1]}), flush=True)
    summary = {k: {"program_max": max(p[k] for p in program),
                   "control_min": min(c[k] for c in control)}
               for k in check.NAMES}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "summary": summary,
                      "control_correct_on": [s for s, ok in
                                             zip(args.seeds, passed) if ok]}),
          flush=True)
    return 1 if any(passed) else 0


if __name__ == "__main__":
    sys.exit(main())
