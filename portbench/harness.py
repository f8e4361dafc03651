"""One run of one cell: set-up (the system from its configuration file, the
benchmark's weights, the route that drives the program, a warm-up of the cell's
shapes), a closed loop of one client for the window, then, with the
program's state dropped, the plain reference over a sample of the window's
batches drawn from the seed, and the result.

`run_cell` takes the device it is given; `run.py` checks for the card first
and refuses to run without one.
"""

from __future__ import annotations

import contextlib
import gc
import random
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, TextIO

import numpy as np
import torch

from . import registry, systems
from .reference import plain
from .routes import Spans, relative_gap
from .trace import Tracer, TraceSummary, summarize
from .traffic import Traffic

WARMUP_INDEX = 1 << 40   # warm-up batches' indices, apart from the window's
BANNED = ("jax", "jaxlib", "flax", "seeme_tpu")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: `seeme_tpu_torch` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclass
class Readings:
    """What a per-layer metric's reader reads: the traced window's batches,
    the benchmark's spans (CUDA-event milliseconds a batch), the trace's
    reduction, the cell's shapes and the operations of one batch."""

    batches: int
    batch_size: int
    spans_ms: Dict[str, List[float]]
    trace: TraceSummary
    shapes: Dict
    batch_flops: float


def p95(values: List[float]) -> float:
    """The 95th percentile of every value (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def end_to_end(times: List[float], batch: int, window_s: float, setup_s: float) -> Dict[str, float]:
    """The end-to-end metrics of an untraced run: every sequence the window
    completed over the window's seconds, the 95th percentile of every
    batch's seconds (in ms), and the set-up's seconds."""
    return {"samples_per_s": len(times) * batch / window_s, "batch_p95_ms": 1e3 * p95(times),
            "setup_s": setup_s}


class Reservoir:
    """k of the window's batches, drawn from the seed as they complete."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def compare(route, kept, ar: plain.Arith, program=None) -> Dict[str, float]:
    """Each compared number over the kept (inputs, outputs) batches: the
    program's outputs (`route.program(outputs)`, or `program(outputs)`)
    against the reference computed by `ar` from the same inputs."""
    pairs: Dict[str, list] = {n: [] for n in route.compared}
    masks: Dict[str, list] = {n: [] for n in route.compared}
    for inp, out in kept:
        prog = (program or route.program)(out)
        with torch.no_grad():
            ref = route.reference(ar, inp)
        m = route.masks(inp) or {}
        for n in route.compared:
            pairs[n].append((prog[n], ref[n]))
            masks[n].append(m.get(n))
        del ref
    gaps = {}
    for n in route.compared:
        mk = masks[n] if all(x is not None for x in masks[n]) else None
        gaps[n] = relative_gap(pairs[n], mk)
    return gaps


def _route(cell: str, seed: int, device):
    bench = registry.benchmark()
    wl = registry.workload(bench, cell)
    conf = registry.config(bench, wl["config"])
    mix = registry.traffic(wl["traffic"])
    route = registry.route(mix["route"])(systems.build(conf, seed, device),
                                         Traffic(mix, conf, seed, device), conf,
                                         registry.reference(wl["config"]))
    return bench, mix, route


def control_cell(cell: str, seed: int, device, batches: Optional[int] = None) -> Dict[str, float]:
    """The control's readings: the reference with TF32 products put in the
    program's place, on the cell's first batches (as many as a run
    compares), against the float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, mix, route = _route(cell, seed, torch.device(device))
    with torch.no_grad():
        route.release()
        kept = [(inp, route.reference(plain.Arith(tf32=True), inp))
                for inp in map(route.prepare, range(batches or int(mix["compare_batches"])))]
    return compare(route, kept, plain.Arith(tf32=False), program=lambda out: out)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, err: TextIO = sys.stderr) -> Dict:
    """Run `cell` once and return its result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.set_num_threads(1)
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    marks = [t_start, time.perf_counter()]          # the ends of the set-up's phases
    bench, mix, route = _route(cell, seed, device)
    sync()
    marks.append(time.perf_counter())
    with torch.no_grad():
        off = Spans(False)
        for k in range(int(mix["warmup_batches"])):
            route.run(route.prepare(WARMUP_INDEX + k), off)
    sync()
    marks.append(time.perf_counter())

    spans = Spans(trace, cuda=on_card)
    tracer = Tracer(on_card) if trace else None
    if tracer is not None:
        tracer.start()
    if on_card:
        # the window's own peak, not the set-up's
        torch.cuda.reset_peak_memory_stats(device)
    sync()
    setup_s = time.perf_counter() - t_start
    marks.append(t_start + setup_s)
    print("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for name, a, b in
                                 zip(("imports", "build", "warm-up", "tracer"), marks, marks[1:])),
          file=err)

    kept = Reservoir(int(mix["compare_batches"]), systems.subseed(seed, "compare"))
    bad = torch.zeros((), dtype=torch.int64, device=device)
    times: List[float] = []
    window = torch.profiler.record_function("bench.window") if trace else contextlib.nullcontext()
    with torch.no_grad(), window:
        w0 = time.perf_counter()
        i = 0
        while True:
            inp = route.prepare(i)
            t0 = time.perf_counter()
            out = route.run(inp, spans)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            bad += (~route.finite_rows(out)).sum()
            kept.offer((inp, out))
            i += 1
            if t1 - w0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - w0
    summary = None
    if tracer is not None:
        t = time.perf_counter()
        events = tracer.stop()
        summary = summarize(events)
        print(f"trace: {len(events)} events reduced in {time.perf_counter() - t:.1f} s", file=err)
        del events
    batches, B = len(times), route.batch
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0   # the window's
    failed = int(bad)

    # per-layer readings, while the shapes are at hand
    metrics: Dict[str, Dict] = {}
    if trace:
        readings = Readings(batches, B, spans.ms(), summary, route.shapes(),
                            route.batch_flops())
        for m in registry.cell_metrics(bench, cell, "per_layer"):
            value = registry.metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(times, B, window_s, setup_s)
        for m in registry.cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the comparison, with the program's state dropped
    route.release()
    del out, inp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gaps = compare(route, kept.items, plain.Arith(tf32=False))
    limits = route.refm.LIMITS
    checks = {n: {"value": gaps[n], "limit": limits[n]} for n in route.compared}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
    result = {"correct": bool(correct), "attempted": batches * B, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = summary.breakdown()
    result["compared"] = checks
    for n, c in checks.items():
        print(f"compared {n} {c['value']!r} limit {c['limit']!r}", file=err)
    return result
