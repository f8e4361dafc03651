"""The train step, the epoch loop and the validation pass
(`seeme_tpu/train/loop.py:41-77`, `:246-`; `train.py:347-375`).

A step is the loss of its stage (`SeeMeSystem.vae_loss` or
`diffusion_loss`), backward, and one AdamW update at the step's learning
rate, with the loss terms fetched from the device once. `run_epoch` takes
its batches through `data/prefetch.py::prefetch_to_device`, as the JAX loop
does (`seeme_tpu/train/loop.py:264-295`): the next batch's copy to the card
overlaps the step. The JAX package's scan, gather and device-resident
variants exist for XLA dispatch and have no counterpart here.

Data parallelism (`parallel/mesh.py`): each rank's step takes its rows of
the batch, through `model`, the stage's loss under
`DistributedDataParallel` (`StageLoss`), whose backward averages the
gradients over the ranks; `shard` (rank, ranks) makes each loss call's
draws at the whole batch's shape and keeps the rank's rows, so they equal
one process's. The loss terms are averaged over the ranks before their
one fetch, and validation's sums too, so both read as one process's.

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
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.prefetch import prefetch_to_device
from ..data.synthetic import to_torch
from ..parallel.mesh import mean_over_ranks

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


def fetch_terms(terms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All loss terms in one device-to-host transfer, averaged over the
    ranks first."""
    keys = sorted(terms)
    stacked = torch.stack([terms[k].detach().reshape(()) for k in keys])
    return dict(zip(keys, mean_over_ranks(stacked).tolist()))


def train_step(system, stage: str, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], count: int, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               model: Optional[nn.Module] = None,
               shard: Tuple[int, int] = ONE) -> Dict[str, float]:
    """One update, the `count`-th (0-based) of the run; returns the loss
    terms. `model` is the stage's `StageLoss` under DDP, `batch` then the
    rank's `shard` of the step's batch."""
    lr = schedule(count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    if draws is None:
        draws = system.loss_draws(stage, batch, generator, shard=shard)
    loss, terms = (model if model is not None else loss_fn(system, stage))(batch, draws=draws)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return fetch_terms(terms)


class _StepClock:
    """Per-step milliseconds: CUDA events on the card, the host clock
    elsewhere; every step ends in the terms' fetch, which waits for it. The
    batch is on the device before the step's first mark (prefetched)."""

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


def run_epoch(system, stage: str, optimizer: torch.optim.Optimizer,
              schedule: Callable[[int], float], count: int,
              batches: Iterable[Dict[str, np.ndarray]],
              generator: Optional[torch.Generator] = None,
              model: Optional[nn.Module] = None, shard: Tuple[int, int] = ONE,
              ) -> Tuple[int, Dict[str, float], List[Dict[str, float]], List[float]]:
    """One pass over host batches (a rank's rows of each, with `model` and
    `shard` as `train_step` takes them), prefetched to the system's device;
    returns (the update count after it, the mean of each term, each step's
    terms, each step's milliseconds)."""
    clock = _StepClock(system.device)
    steps = []
    for b in prefetch_to_device(batches, system.device):
        clock.mark()
        terms = train_step(system, stage, optimizer, schedule, count, b, generator,
                           model=model, shard=shard)
        clock.mark()
        count += 1
        steps.append(terms)
    means = {k: sum(s[k] for s in steps) / len(steps) for k in steps[0]} if steps else {}
    return count, means, steps, clock.intervals_ms()


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
