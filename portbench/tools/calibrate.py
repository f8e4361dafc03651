"""Readings that a cell's comparison limits are set from, on the card, in one
process: the program's widest gaps on many seeds (each a short window at the
cell's own load, comparing as many batches as a run does) and the
control's (the reference with TF32 products in the program's place) on a
few.

    python3 -m portbench.tools.calibrate --workload NAME --seeds 12 --control_seeds 3
        [--seconds 3] [--out FILE.json]

Prints one JSON line a seed, and the largest program reading and the
smallest control reading of each compared number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.tools.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control_seeds", type=int, default=3)
    p.add_argument("--first_seed", type=int, default=3_000_000_017)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    devnull = open(os.devnull, "w")
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0", err=devnull)
        row = {"kind": "program", "seed": seed, "correct": r["correct"],
               "gaps": {n: c["value"] for n, c in r["compared"].items()},
               "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    for k in range(args.control_seeds):
        seed = args.first_seed + 104729 * (k + 1)
        t = time.perf_counter()
        gaps = harness.control_cell(args.workload, seed, "cuda:0")
        row = {"kind": "control", "seed": seed, "gaps": gaps, "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    names = rows[0]["gaps"].keys()
    prog = [r for r in rows if r["kind"] == "program"]
    ctrl = [r for r in rows if r["kind"] == "control"]
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
               "lower": {n: max(r["gaps"][n] for r in prog) for n in names} if prog else {},
               "upper": {n: min(r["gaps"][n] for r in ctrl) for n in names} if ctrl else {}}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
