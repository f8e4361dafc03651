"""Host-to-device input prefetching (`seeme_tpu/data/prefetch.py:19-41`).

The EgoBody batches carry 20 000-point scene clouds (about 15 MB a batch at
batch 64); copied synchronously inside the step, the copy of batch N+1
waits behind the step of batch N. `prefetch_to_device` keeps `size` batches
in flight instead: each numpy batch is staged in pinned host memory (a
memcpy on the calling thread) and copied on a side CUDA stream with
`non_blocking=True`, so the copy engine's transfer overlaps the step that
runs on the consumer's stream. Before a batch is handed out,
the consumer's stream waits on the event its copy recorded, and every tensor
is `record_stream`-ed on the consumer's stream, so the caching allocator
does not reuse its memory while a step still reads it. Entries that are not
arrays (captions) pass through untouched; nested dicts are walked. On a CPU
device it is the plain conversion (`data/synthetic.py::to_torch`), through
the same look-ahead.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Dict, Iterable, Iterator

import numpy as np
import torch

from .synthetic import to_torch


def _map_arrays(batch: Dict, fn) -> Dict:
    """`fn` of every array or tensor of a nested batch; other entries as they are."""
    return {k: _map_arrays(v, fn) if isinstance(v, dict)
            else fn(v) if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def _walk_tensors(batch: Dict):
    for v in batch.values():
        if isinstance(v, dict):
            yield from _walk_tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One copy stream per device for the life of the process: the caching
    allocator keeps a pool per stream, so a new stream for every epoch
    would allocate that epoch's batches afresh (cudaMalloc) and leave the
    old pools unused."""
    return torch.cuda.Stream(device)


def lookahead(iterator: Iterable, put: Callable, size: int) -> Iterator:
    """`put(item)` of every item, in order, `size` items ahead: before item k
    is yielded, items up to k + size (or all there are) have been put, as
    the JAX package's queue does."""
    if size < 1:
        raise ValueError(f"prefetch size {size} < 1")
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for item in it:
        queue.append(put(item))
        if len(queue) == size:
            break
    while queue:
        out = queue.popleft()
        for item in it:
            queue.append(put(item))
            break
        yield out


def prefetch_to_device(iterator: Iterable[Dict], device, size: int = 2) -> Iterator[Dict]:
    """The batches of `iterator` as tensors on `device`, `size` copies ahead."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from lookahead(iterator, lambda b: to_torch(b, device), size)
        return
    side = _side_stream(device)

    def put(batch):
        pinned = _map_arrays(
            batch, lambda v: torch.as_tensor(np.ascontiguousarray(v)).pin_memory())
        with torch.cuda.stream(side):
            on_device = _map_arrays(pinned, lambda t: t.to(device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        # the host allocator keeps each pinned block until its copy has run
        return on_device, done

    for on_device, done in lookahead(iterator, put, size):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in _walk_tensors(on_device):
            t.record_stream(consumer)
        yield on_device
