"""Timing and memory (`seeme_tpu/utils/profiling.py`).

`StepTimer` keeps the reference's `times.txt` contract (per-step wall clock,
batch-normalised means every `print_every` steps, one float a line:
`mld/models/modeltype/base.py:44-53`); on the card each step ends in a
synchronise, so the clock holds the device's work. `device_trace` is the
`torch.profiler` counterpart of the JAX package's `jax.profiler` trace, a
Chrome trace under `log_dir`. `memory_stats` gives the host's resident set
(from `/proc/self/status`: psutil is not on the card's machine) and, on the
card, the bytes the caching allocator holds for tensors.

`span(name)` and `count(name)` are the program's own spans and counters at
its layer boundaries; they record only while a torch profiler records (the
profiler's state is the one switch), so an untraced run pays one check a
call. A span opens the profiler range `seeme.<name>` (on the trace's clock,
under the caller's ranges), records a CUDA event pair on the current stream
(the host clock where CUDA is not in use) and the host's start and end, and
notes its parent, the innermost span open on the thread. Spans and counters
stay in memory until `summary()` reads them and `clear()` drops them.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled

PREFIX = "seeme."   # the profiler ranges of the program's spans
# the kernel wrappers whose `.launches` `summary()` reports, by module
LAUNCH_COUNTERS = {"seeme_tpu_torch.ops.pointnet_fused": ("fused_input_block", "fused_split_block"),
                   "seeme_tpu_torch.ops.denoiser_fused": ("ddim_fused", "ddim_fused_grid",
                                                          "ddim_fused_tok"),
                   "seeme_tpu_torch.ops.gcn_fused": ("gcn_fused",)}


class StepTimer:
    def __init__(self, batch_size: int, print_every: int = 100,
                 device: Optional[torch.device] = None):
        self.batch_size = batch_size
        self.print_every = print_every
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.device = device
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter() - self._t0)
        n = len(self.times)
        if n % self.print_every == 0:
            mean = sum(self.times[-self.print_every:]) / self.print_every / self.batch_size
            print(f"{self.print_every} iter mean Time (batch_size: {self.batch_size}): {mean}")
        return False

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.writelines(f"{t}\n" for t in self.times)


class _Span:
    """One program span: its name, key, parent and clocks."""

    __slots__ = ("name", "key", "parent", "range", "start", "end", "t0", "t1")

    def __init__(self, name: str, key):
        self.name, self.key = name, key

    def __enter__(self):
        stack = _RECORDER.open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.range = torch.profiler.record_function(
            PREFIX + self.name, None if self.key is None else str(self.key))
        self.range.__enter__()
        self.start = self.end = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()
        self.t1 = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _RECORDER.open_spans().pop()
        _RECORDER.spans.append(self)
        return False


class Recorder:
    """The process's closed spans, in the order they closed, and its
    counters' totals."""

    def __init__(self):
        self.spans: List[_Span] = []
        self.counts: Dict[str, int] = {}
        self._local = threading.local()

    def open_spans(self) -> List[_Span]:
        """The spans open on the calling thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def summary(self) -> Dict:
        """{"spans": {name: {"count", "parents", "device_ms",
        "device_self_ms", "host_ms", "host_self_ms"[, "by_key"]}},
        "counters": {name: total}, "launches": {kernel wrapper: launches}}.
        `parents` are the names of the spans it opened under; device
        milliseconds are the span's CUDA events (its host clock where it
        recorded none); self time is the duration less the part its child
        spans cover; `by_key` gives a keyed span's device milliseconds by
        key."""
        if any(s.start is not None for s in self.spans):
            torch.cuda.synchronize()
        timed, children = [], {}
        for s in self.spans:
            host = (s.t1 - s.t0) / 1e6
            dev = s.start.elapsed_time(s.end) if s.start is not None else host
            timed.append((s, dev, host))
            if s.parent is not None:
                d, h = children.get(id(s.parent), (0.0, 0.0))
                children[id(s.parent)] = (d + dev, h + host)
        spans: Dict[str, Dict] = {}
        for s, dev, host in timed:
            e = spans.setdefault(s.name, {"count": 0, "parents": [], "device_ms": 0.0,
                                          "device_self_ms": 0.0, "host_ms": 0.0,
                                          "host_self_ms": 0.0})
            d, h = children.get(id(s), (0.0, 0.0))
            e["count"] += 1
            if s.parent is not None and s.parent.name not in e["parents"]:
                e["parents"].append(s.parent.name)
            e["device_ms"] += dev
            e["device_self_ms"] += dev - d
            e["host_ms"] += host
            e["host_self_ms"] += host - h
            if s.key is not None:
                by_key = e.setdefault("by_key", {})
                by_key[str(s.key)] = by_key.get(str(s.key), 0.0) + dev
        for e in spans.values():
            e["parents"].sort()
        return {"spans": spans, "counters": dict(self.counts), "launches": _launches()}

    def clear(self) -> None:
        self.spans.clear()
        self.counts.clear()


def _launches() -> Dict[str, int]:
    """Each kernel wrapper's `.launches` as it stands (none from a module
    not yet imported)."""
    out = {}
    for module, names in LAUNCH_COUNTERS.items():
        mod = sys.modules.get(module)
        if mod is not None:
            out.update({name: getattr(mod, name).launches for name in names})
    return out


_RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def span(name: str, key=None):
    """A context manager: the span `name` (with `key`, such as a request's
    identifier) while a torch profiler records, else nothing."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, key)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while a torch profiler records."""
    if not _profiler_enabled():
        return
    _RECORDER.counts[name] = _RECORDER.counts.get(name, 0) + n


def summary() -> Dict:
    """What the spans and counters recorded since the last `clear()`
    (`Recorder.summary`); synchronises the card first."""
    return _RECORDER.summary()


def clear() -> None:
    """Drop every recorded span and counter."""
    _RECORDER.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """`torch.profiler` over a code region (the card's kernels too when
    there is one); writes `<log_dir>/trace.json`, a Chrome trace."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def memory_stats(device: Optional[torch.device] = None) -> dict:
    """{"host_rss_gb", and on the card "device_gb"}: the psutil line of
    `mld/callback/progress.py:52` (the resident set, VmRSS) with the
    device's allocated bytes."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["host_rss_gb"] = int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    if device is not None and torch.device(device).type == "cuda":
        out["device_gb"] = torch.cuda.memory_allocated(device) / 1e9
    return out
