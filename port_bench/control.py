"""The readings that a cell's limits are set from (not part of a run).

    python3 -m port_bench.control --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--seconds 3] [--out readings.jsonl]

Runs the cell's own path, at its own size, for a short window on each of
``--seeds`` (the lower readings: the largest each compared number reads
over sound runs) and the control on each of ``--control-seeds``: the same
cell with the port's bf16 path switched on, the nearest precision below
the configuration's f32 (the upper readings: the smallest each number
reads). One process, so the set-up's fixed costs are paid once. Prints a
JSON line per run and a summary line last; ``--out`` also writes them.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

CONTROL = {"dtype": "bf16"}


def readings(workload: str, seeds, control_seeds, seconds: float, device="cuda",
             overrides: dict | None = None, out=None) -> dict:
    from port_bench import harness

    lines = []
    for kind, seed_list, extra in (("program", seeds, {}), ("control", control_seeds, CONTROL)):
        for seed in seed_list:
            r = harness.run_cell(workload, seed, seconds, False, device,
                                 overrides={**(overrides or {}), **extra})
            line = {"kind": kind, "seed": seed, "correct": r["correct"],
                    "attempted": r["attempted"],
                    "checks": {k: c["value"] for k, c in r["checks"].items()}}
            lines.append(line)
            print(json.dumps(line), flush=True)
            if out is not None:
                print(json.dumps(line), file=out, flush=True)

    def pick(kind, fn):
        vals = {}
        for line in lines:
            if line["kind"] == kind:
                for k, v in line["checks"].items():
                    vals.setdefault(k, []).append(math.inf if v is None else v)
        return {k: fn(v) for k, v in vals.items()}

    summary = {"workload": workload, "lower": pick("program", max),
               "upper": pick("control", min)}
    print(json.dumps(summary), flush=True)
    if out is not None:
        print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    try:
        readings(args.workload, args.seeds, args.control_seeds, args.seconds, out=out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
