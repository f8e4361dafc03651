"""Reduction of a `torch.profiler` trace of the measured window: the device's
busy seconds (the union of its kernel, copy and set intervals inside the
benchmark's `bench.window` range), each device operation's count and
seconds, and the device's idle gaps by what the host was doing when each
began (the benchmark's span around it, and the innermost operation on the
host thread that ran the window)."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"


class Tracer:
    """The profiler over the window (CPU ranges and operations, and the
    card's kernels, copies and sets), stopped without building the
    profiler's per-event Python objects: the reduction reads the raw
    events."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler

        self._prof = profiler.profile(use_device="cuda" if cuda else None, use_kineto=True)

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self):
        from torch.autograd import _disable_profiler, profiler

        results = _disable_profiler()
        getattr(profiler, "_run_on_profiler_stop", lambda: None)()
        self._prof.entered = False
        return results.events()


def clean(name: str, width: int = 64) -> str:
    """A name cut to `width` characters of letters, digits and `_.:/ -`."""
    return re.sub(r"[^A-Za-z0-9_.:/ -]", "_", name)[:width]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]] = field(default_factory=dict)   # name -> (count, s)
    gaps: Dict[str, float] = field(default_factory=dict)              # label -> s

    def kernel(self, part: str) -> Tuple[int, float]:
        """Launches and seconds of the device operations whose name holds `part`."""
        n = s = 0
        for name, (c, t) in self.ops.items():
            if part in name:
                n, s = n + c, s + t
        return n, s

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[clean(k), v[1]] for k, v in ops],
                "idle_gaps": [[clean(k), v] for k, v in gaps]}


def _ns(ev) -> Tuple[int, int]:
    start = ev.start_ns()
    return start, start + ev.duration_ns()


def _annotation(ev) -> bool:
    """A range the benchmark marked, which the trace repeats on the device's
    timeline: no work of the device."""
    return ev.name().startswith("bench.") or bool(getattr(ev, "is_user_annotation", bool)())


def summarize(events) -> TraceSummary:
    """`events`: the profiler's raw events (`Tracer.stop()`)."""
    from torch.autograd import DeviceType

    window = [ev for ev in events if ev.name() == WINDOW and ev.device_type() == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} '{WINDOW}' ranges, not 1")
    w0, w1 = _ns(window[0])
    thread = window[0].start_thread_id()
    device, host = [], []
    for ev in events:
        a, b = _ns(ev)
        if b <= w0 or a >= w1:
            continue
        if ev.device_type() == DeviceType.CUDA:
            if not _annotation(ev):
                device.append((max(a, w0), min(b, w1), ev.name()))
        elif ev.start_thread_id() == thread and ev.name() != WINDOW:
            host.append((a, b, ev.name()))
    ops: Dict[str, List] = defaultdict(lambda: [0, 0.0])
    for a, b, name in device:
        ops[name][0] += 1
        ops[name][1] += (b - a) / 1e9
    # the union of the device's intervals, and the gaps between them
    busy, gaps, end = 0, [], w0
    for a, b, _ in sorted(device):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < w1:
        gaps.append((end, w1))
    return TraceSummary((w1 - w0) / 1e9, busy / 1e9, {k: (v[0], v[1]) for k, v in ops.items()},
                        _label_gaps(gaps, host))


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Each gap's seconds under '<benchmark span> / <innermost host op>' at
    its start; 'between_batches' outside every benchmark span."""
    host.sort(key=lambda e: (e[0], -e[1]))
    out: Dict[str, float] = defaultdict(float)
    stack, k = [], 0
    for g0, g1 in gaps:
        while k < len(host) and host[k][0] <= g0:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        spans = [e[2] for e in stack if e[2].startswith("bench.")]
        ops = [e[2] for e in stack if not e[2].startswith("bench.")]
        label = spans[0] if spans else "between_batches"
        if ops:
            label += " / " + ops[-1]
        out[label] += (g1 - g0) / 1e9
    return dict(out)
