"""Readings that set a cell's limits: for each seed, one run of the cell
(a short window at the cell's own load) and the numbers its check
compares, for the program and, with --control, for the control (the
reference computed in float8 in the program's place, on the same sample).
Not run by the benchmark's runs.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --seconds 20 [--control]

One JSON line a seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    control = {}

    def judge(self, numbers_of):
        if args.control:
            control.update(numbers_of("fp8"))
        return numbers_of("fp32")

    run.Ctx.judge = judge
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        control.clear()
        out, lines = run.run_cell(args.workload, seed, args.seconds, False)
        print("\n".join(lines), file=sys.stderr)
        print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in out["checks"].items()},
                          "control": dict(control), "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
