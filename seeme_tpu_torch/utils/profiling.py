"""Timing and memory (`seeme_tpu/utils/profiling.py`).

`StepTimer` keeps the reference's `times.txt` contract (per-step wall clock,
batch-normalised means every `print_every` steps, one float a line:
`mld/models/modeltype/base.py:44-53`); on the card each step ends in a
synchronise, so the clock holds the device's work. `device_trace` is the
`torch.profiler` counterpart of the JAX package's `jax.profiler` trace, a
Chrome trace under `log_dir`. `memory_stats` gives the host's resident set
(from `/proc/self/status`: psutil is not on the card's machine) and, on the
card, the bytes the caching allocator holds for tensors.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


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

    @property
    def seqs_per_sec(self) -> float:
        warm = self.times[1:] or self.times
        return self.batch_size / (sum(warm) / len(warm))


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
