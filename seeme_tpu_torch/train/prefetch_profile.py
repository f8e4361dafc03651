"""Prefetched against synchronous stage-2 training steps on the card.

    python -m seeme_tpu_torch.train.prefetch_profile [--steps 8] [--rounds 3]

Builds the EgoBody stage-2 trainer (`mld_egobody`, B = 64, full width) with
the raw 20 000-point scene in every batch (no feature cache), warms it with
one epoch each way, then runs `--rounds` rounds of `--steps` steps on the
same batches, each round in the order A B B A with A alternating between a
loop of `train_step(to_torch(b))` and `run_epoch` (its batches through
`data/prefetch.py`). Each epoch is timed on the host clock, ending in a
synchronise. Then one epoch each way under `torch.profiler`, which gives
the host time of the
operations that move the batch: the pinned staging memcpy (`aten::copy_`),
CUDA's pageable copies (`cudaMemcpyAsync`), device and pinned allocations
(`cudaMalloc`, `cudaHostAlloc`), and the waits (`cudaStreamSynchronize`).
Prints one JSON line. Needs a card and nvcc (the PointNet kernels run in
every step).
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import tempfile
import time

import torch

WATCH = ("aten::copy_", "cudaMemcpyAsync", "cudaMalloc", "cudaHostAlloc",
         "cudaStreamSynchronize", "cudaStreamWaitEvent")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.train.prefetch_profile")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    from ..data.synthetic import to_torch
    from .__main__ import Trainer, parse_args
    from .loop import run_epoch, train_step

    work = tempfile.TemporaryDirectory(prefix="prefetch_profile_")
    tr = Trainer(parse_args(["--preset", "mld_egobody", "--epochs", "1",
                             "train.feature_cache=False", "--out", work.name]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = tr.device
    host = list(itertools.islice(itertools.chain.from_iterable(
        tr.train_batches(e) for e in itertools.count()), args.steps))
    count = [0]

    def synchronous():
        for b in host:
            train_step(tr.system, tr.stage, tr.optimizer, tr.schedule, count[0], to_torch(b, dev),
                       tr.generator)
            count[0] += 1

    def prefetched():
        count[0] = run_epoch(tr.system, tr.stage, tr.optimizer, tr.schedule, count[0],
                             iter(host), tr.generator)[0]

    def ms_a_step(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return round(1e3 * (time.perf_counter() - t0) / len(host), 3)

    synchronous()
    prefetched()
    rounds = []
    for r in range(args.rounds):  # ABBA, the first of the pair alternating by round
        first, second = (synchronous, prefetched) if r % 2 == 0 else (prefetched, synchronous)
        times = {first.__name__: [], second.__name__: []}
        for fn in (first, second, second, first):
            times[fn.__name__].append(ms_a_step(fn))
        rounds.append(times)
    host_ms = {}
    for fn in (synchronous, prefetched):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        host_ms[fn.__name__] = {e.key: {"calls": e.count,
                                        "ms": round(e.self_cpu_time_total / 1e3, 3)}
                                for e in prof.key_averages() if e.key in WATCH}
    mb = sum(v.nbytes for v in host[0].values() if hasattr(v, "nbytes")) / 1e6
    out = {"card": card, "batch_mb": round(mb, 1), "steps": args.steps,
           "ms_a_step": rounds, "host_ms_one_epoch": host_ms}
    print(json.dumps(out), flush=True)
    work.cleanup()
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
