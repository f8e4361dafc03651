"""Sets of runs of one cell, each run the benchmark's own command in a process
of its own, one after another, with what the host and the card were doing
around each: the card's clocks, power and temperature just before and just
after the run (`nvidia-smi`, so that no query of the driver runs beside the
window), and before each run the seconds a fixed loop of pure Python takes
(the host's pace) and the load average.

    python3 -m portbench.tools.sets --workload NAME --seeds S1,S2,... [--sets 2]
        [--seconds 25] [--trace 0] [--out FILE.jsonl]

Every set runs the same seeds. Prints one JSON line a run and, at the end,
each end-to-end metric's median and spread (first to third quartile over
the median, `statistics.quantiles(values, n=4)`) in each set.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def host_pace(n: int = 2_000_000) -> float:
    """Seconds of a fixed loop of pure Python."""
    t = time.perf_counter()
    acc = 0
    for k in range(n):
        acc += k & 7
    return time.perf_counter() - t


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def card() -> dict:
    """The card's clocks (MHz), power (W) and temperature (C) now."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={CLOCKS}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split(",")
    return dict(zip(CLOCKS.split(","), (x.strip() for x in out)))


def one_run(args, seed: int) -> dict:
    row = {"seed": seed, "host_pace_s": host_pace(), "loadavg": os.getloadavg()[0],
           "card_before": card()}
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", args.workload,
                          "--seed", str(seed), "--seconds", str(args.seconds),
                          "--trace", str(args.trace)], cwd=ROOT, capture_output=True, text=True)
    row["process_s"] = time.perf_counter() - t
    row["card_after"] = card()
    row["rc"] = out.returncode
    row["stderr_tail"] = [ln for ln in out.stderr.splitlines()
                          if ln.startswith(("set-up:", "compared", "trace:", "portbench"))]
    try:
        row["result"] = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        row["result"] = None
        row["stderr_end"] = out.stderr[-2000:]
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.tools.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated; every set runs them all")
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=int, default=25)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    per_set = []
    for k in range(args.sets):
        rows = []
        for seed in seeds:
            row = dict(one_run(args, seed), set=k + 1, workload=args.workload)
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        per_set.append(rows)
    summary = {"workload": args.workload, "sets": []}
    for rows in per_set:
        done = [r["result"] for r in rows if r["result"]]
        entry = {"runs": len(rows), "results": len(done),
                 "correct": sum(bool(r["correct"]) for r in done)}
        names = done[0]["metrics"] if done else {}
        for n in names:
            vals = [r["metrics"][n]["value"] for r in done]
            if len(vals) >= 2:
                entry[n] = {"median": statistics.median(vals), "spread": spread(vals),
                            "values": vals}
        summary["sets"].append(entry)
    print(json.dumps(summary), flush=True)
    if sink:
        sink.write(json.dumps(summary) + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
