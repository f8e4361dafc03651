"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

It needs a CUDA card (as many as the cell asks for) and the port
(`seeme_tpu_torch`) beside it; without either it exits non-zero and prints
no result. The last line of standard output is the result's JSON object;
the last lines of standard error give each compared number beside its
limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness, registry

    chips = registry.workload(registry.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", t_start=T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
