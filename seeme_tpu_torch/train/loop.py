"""The train step, the two epoch routes and the validation pass
(`seeme_tpu/train/loop.py`; `train.py:246-375`).

A step (`device_step`) is the loss of its stage (`SeeMeSystem.vae_loss`
or `diffusion_loss`), backward, and one AdamW update at the step's
learning rate; it leaves its loss terms on the device, stacked in one
tensor. A fetch (`fetch_steps`) moves the terms of a group of steps to the
host in one transfer, averaged over the ranks first. `train_step` is one
step and its fetch.

The JAX package's two dispatch routes have their counterparts here, with
`lax.scan` over a group of k steps as a Python loop whose k steps share one
fetch:

- `run_epoch(..., steps_per_dispatch=k)` is `run_epoch(scan_step=...)`
  over `make_scan_train_step` (`seeme_tpu/train/loop.py:109-142`,
  `:246-304`): host batches, prefetched to the device by
  `data/prefetch.py::prefetch_to_device` (the next batch's copy overlaps
  the step), k steps, then one fetch of the group's k x terms; the tail
  group, with fewer than k batches, is fetched alone, so every batch is
  trained on once whatever k is;
- `run_epoch_device` is `run_epoch_device` over
  `make_gather_scan_train_step` (`:144-230`): the train split on the
  device (`make_device_data`), each group's k index rows copied there in
  one transfer, each step's batch gathered with `index_select`.

Both routes train the same batches in the same order (the datamodule's
`batch_indices`, which its `batches` slice too) with the same draws, so
their results are equal.

Data parallelism (`parallel/mesh.py`): each rank's step takes its rows of
the batch, through `model`, the stage's loss under
`DistributedDataParallel` (`StageLoss`), whose backward averages the
gradients over the ranks; `shard` (the rank's coordinate on the data
axis, the axis' size) makes each loss call's draws at the whole batch's
shape and keeps the rank's rows, so they equal one process's. On the
device route each rank gathers only its rows of each index row
(`stacked_batch_sharding`'s counterpart). The loss terms are averaged over
the ranks before their fetch, and validation's sums too, so both read as
one process's.

Random draws: each loss call draws its noise from the explicit `generator`
(or takes injected `draws`). `nn.Dropout` takes no generator, so dropout
draws from torch's default generators, which the trainer seeds from the
preset's seed (`torch.manual_seed`) and checkpoints save and restore.
Validation runs with the modules in the modes training left them, so
dropout is on as in the JAX package's validation, which passes
`deterministic=False` (`seeme_tpu/models/seeme.py:345-351`, `:453`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.prefetch import prefetch_to_device
from ..data.synthetic import to_torch
from ..parallel.mesh import mean_over_ranks, rows as rank_rows

ONE = (0, 1)  # the shard of a process that holds the whole batch


def loss_fn(system, stage: str):
    return system.vae_loss if stage == "vae" else system.diffusion_loss


class StageLoss(nn.Module):
    """A stage's loss as a module's forward, (batch, draws) -> (loss, terms):
    the module `DistributedDataParallel` wraps, since DDP hooks the
    gradients of what its forward ran."""

    def __init__(self, system: nn.Module, stage: str):
        super().__init__()
        self.system, self.stage = system, stage

    def forward(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        return loss_fn(self.system, self.stage)(batch, draws=draws)


def stack_terms(terms: Dict[str, torch.Tensor]) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """(the sorted term names, the terms stacked in that order, detached)."""
    keys = tuple(sorted(terms))
    return keys, torch.stack([terms[k].detach().reshape(()) for k in keys])


def fetch_steps(keys: Sequence[str], rows: Sequence[torch.Tensor]) -> List[Dict[str, float]]:
    """Each step's terms of a group (`stack_terms` rows) in one
    device-to-host transfer, averaged over the ranks first."""
    values = mean_over_ranks(torch.stack(list(rows))).tolist()
    return [dict(zip(keys, v)) for v in values]


def fetch_terms(terms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All loss terms of one call in one device-to-host transfer, averaged
    over the ranks first."""
    keys, row = stack_terms(terms)
    return fetch_steps(keys, [row])[0]


def device_step(system, stage: str, optimizer: torch.optim.Optimizer,
                schedule: Callable[[int], float], count: int, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                model: Optional[nn.Module] = None,
                shard: Tuple[int, int] = ONE) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """One update, the `count`-th (0-based) of the run; returns its loss
    terms on the device (`stack_terms`), unfetched. `model` is the stage's
    `StageLoss` under DDP, `batch` then the rank's `shard` of the step's
    batch."""
    lr = schedule(count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    if draws is None:
        draws = system.loss_draws(stage, batch, generator, shard=shard)
    loss, terms = (model if model is not None else loss_fn(system, stage))(batch, draws=draws)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return stack_terms(terms)


def train_step(system, stage: str, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], count: int, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               model: Optional[nn.Module] = None,
               shard: Tuple[int, int] = ONE) -> Dict[str, float]:
    """`device_step` and the fetch of its terms."""
    keys, row = device_step(system, stage, optimizer, schedule, count, batch, generator, draws,
                            model, shard)
    return fetch_steps(keys, [row])[0]


class _StepClock:
    """Per-step milliseconds: CUDA events on the card (the device's time
    from one step's start to its end, the host running ahead of it between
    fetches), the host clock elsewhere. On the host route the batch is on
    the device before the step's first mark (prefetched); on the device
    route the step's gather lies inside its marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks[::2], self.marks[1::2])]
        return [1e3 * (b - a) for a, b in zip(self.marks[::2], self.marks[1::2])]


def groups(items: Iterable, k: int) -> Iterator[list]:
    """`items` in lists of `k`, the last one shorter when k does not divide them."""
    group: list = []
    for item in items:
        group.append(item)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def _means(steps: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: sum(s[k] for s in steps) / len(steps) for k in steps[0]} if steps else {}


EpochResult = Tuple[int, Dict[str, float], List[Dict[str, float]], List[float]]


def run_epoch(system, stage: str, optimizer: torch.optim.Optimizer,
              schedule: Callable[[int], float], count: int,
              batches: Iterable[Dict[str, np.ndarray]],
              generator: Optional[torch.Generator] = None,
              model: Optional[nn.Module] = None, shard: Tuple[int, int] = ONE,
              steps_per_dispatch: int = 1) -> EpochResult:
    """One pass over host batches (a rank's rows of each, with `model` and
    `shard` as `train_step` takes them), prefetched to the system's device,
    their terms fetched once every `steps_per_dispatch` steps; returns (the
    update count after it, the mean of each term, each step's terms, each
    step's milliseconds)."""
    clock = _StepClock(system.device)
    steps: List[Dict[str, float]] = []
    prefetched = prefetch_to_device(batches, system.device)
    for group in groups(prefetched, max(int(steps_per_dispatch), 1)):
        rows = []
        for b in group:
            clock.mark()
            keys, row = device_step(system, stage, optimizer, schedule, count, b, generator,
                                    model=model, shard=shard)
            clock.mark()
            count += 1
            rows.append(row)
        steps += fetch_steps(keys, rows)
    return count, _means(steps), steps, clock.intervals_ms()


def make_device_data(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The split's per-sample arrays (row i <-> sample i) as tensors on
    `device`, each copied once."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in arrays.items()}


def run_epoch_device(system, stage: str, optimizer: torch.optim.Optimizer,
                     schedule: Callable[[int], float], count: int,
                     data: Dict[str, torch.Tensor], index_batches: Iterable[np.ndarray],
                     generator: Optional[torch.Generator] = None,
                     model: Optional[nn.Module] = None, shard: Tuple[int, int] = ONE,
                     steps_per_dispatch: int = 8) -> EpochResult:
    """One pass over the index stream (`datamodule.batch_indices`) of a
    split held on the device (`make_device_data`): each group of
    `steps_per_dispatch` index rows goes to the device in one copy, each
    step gathers its batch there (the rank's `shard` of the row), and the
    group's terms are fetched once; returns what `run_epoch` returns."""
    device = system.device
    clock = _StepClock(device)
    steps: List[Dict[str, float]] = []
    for group in groups(index_batches, max(int(steps_per_dispatch), 1)):
        idx = torch.as_tensor(np.stack(group).astype(np.int64))
        if device.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(device, non_blocking=True)
        rows = []
        for sel in idx:
            clock.mark()
            mine = rank_rows(sel, shard)
            batch = {k: v.index_select(0, mine) for k, v in data.items()}
            keys, row = device_step(system, stage, optimizer, schedule, count, batch, generator,
                                    model=model, shard=shard)
            clock.mark()
            count += 1
            rows.append(row)
        steps += fetch_steps(keys, rows)
    return count, _means(steps), steps, clock.intervals_ms()


@torch.no_grad()
def validate(system, stage: str, batches: Iterable[Tuple[Dict[str, np.ndarray], int]],
             shard: Tuple[int, int] = ONE) -> Dict[str, float]:
    """Mean loss terms over `eval_batches` (the padded tail batch counts as
    a whole one, as in the JAX package); the draws come from a generator
    seeded with 0 at every call, as the JAX trainer's validation keys come
    from `PRNGKey(0)`, so two validations of the same weights draw alike.
    With `shard`, the batches are a rank's rows, the draws are the whole
    batch's, and each batch's terms are averaged over the ranks."""
    gen = torch.Generator(device=system.device).manual_seed(0)
    acc: Dict[str, float] = {}
    n = 0
    for b, _ in batches:
        batch = to_torch(b, system.device)
        draws = system.loss_draws(stage, batch, gen, shard=shard)
        _, terms = loss_fn(system, stage)(batch, draws=draws)
        for k, v in fetch_terms(terms).items():
            acc[k] = acc.get(k, 0.0) + v
        n += 1
    return {k: v / max(n, 1) for k, v in acc.items()}
