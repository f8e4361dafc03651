"""Data parallelism over processes and the (data, model) mesh
(`seeme_tpu/parallel/mesh.py`).

The reference trains with PyTorch Lightning's DDP over NCCL
(`train.py:127-139`, SURVEY.md §2.4); the JAX package jits one step over a
(data, model) device mesh with the batch sharded on ``data``. The port is
the reference's form: one process a rank, `torch.distributed`, and
`DistributedDataParallel`, which all-reduces the gradients. The names are
the JAX module's, so each has its counterpart:

- `initialize_multihost` joins the process group (torchrun's environment,
  or an explicit address), as `jax.distributed.initialize` does;
- `make_mesh` is `init_device_mesh` over the world with dims ("data",
  "model"), the ranks laid out row-major as the JAX mesh reshapes its
  device list (`:35`): rank r sits at data coordinate r // m and model
  coordinate r % m; a model axis that does not divide the world is refused
  by name (`:32-34`);
- `batch_sharding` / `shard_batch` give a rank its contiguous rows of a
  host batch on its data coordinate (the model-axis ranks of one data
  coordinate take the same rows), the counterpart of
  `jax.make_array_from_process_local_data`; `rows` of an index row is the
  device route's `stacked_batch_sharding` (`train/loop.py::run_epoch_device`);
- `replicated` is DDP's broadcast of the group's first rank's module
  state at construction, then the gradient all-reduce of every step, over
  the world or over a rank's data-axis group (`shardings.shard_params`);
- `allreduce_metric_sums` sums metric accumulators over the ranks.

The train CLI builds the mesh from `MESH.MODEL_AXIS` and keeps every
parameter replicated under DDP over the world, as `train.py:238` does with
`make_train_step(mesh)`: on a model axis of m, m ranks compute the same
rows, so the result is one process's. Sharding parameters over the model
axis is `shardings.shard_params`, which no CLI calls, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

MODEL_AXIS_KEY = "MESH.MODEL_AXIS"


def check_model_axis(model_axis, world: int) -> int:
    """The model axis as an int; raises, naming `MESH.MODEL_AXIS`, unless it
    divides the `world` ranks (`seeme_tpu/parallel/mesh.py:32-34`)."""
    model_axis = int(model_axis)
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"{MODEL_AXIS_KEY}={model_axis} does not divide the {world} rank(s) "
                         "into a (data, model) mesh")
    return model_axis


def process_rank() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def under_torchrun() -> bool:
    """Whether torchrun's environment names this process's place in a world."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def local_device(device) -> torch.device:
    """A rank's device: `cuda:{LOCAL_RANK % device_count}` on a card (ranks
    beyond the cards share them), the CPU as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device, local_world: int) -> str:
    """NCCL when every rank of this host has a card of its own (NCCL refuses
    two ranks on one device), else gloo, which also takes CUDA tensors for
    the all-reduce and broadcast DDP needs."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_nccl_available() and \
            local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> Tuple[torch.device, str]:
    """Join the process group; returns (this rank's device, backend).

    With no address, `init_process_group` reads torchrun's environment
    (`env://`: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK and
    LOCAL_WORLD_SIZE place the rank on a card), as JAX reads a pod's. With
    one, it is `host:port` (TCP) or a full init method such as
    `file:///path`, with `num_processes` and `process_id` given."""
    if coordinator_address is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and process_id")
        rank, world = int(process_id), int(num_processes)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = choose_backend(device, local_world)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return device, backend


def make_mesh(data_axis: Optional[int] = None, model_axis: int = 1,
              device_type: str = "cuda"):
    """A ("data", "model") `DeviceMesh` over the world, ranks row-major."""
    from torch.distributed.device_mesh import init_device_mesh

    world = process_rank()[1]
    model_axis = check_model_axis(model_axis, world)
    if data_axis is None:
        data_axis = world // model_axis
    if data_axis * model_axis != world:
        raise ValueError(f"mesh {data_axis} x {model_axis} does not cover {world} ranks")
    return init_device_mesh(device_type, (data_axis, model_axis), mesh_dim_names=("data", "model"))


def join_world(device: torch.device, model_axis: int = 1):
    """(device, backend, mesh, joined) of this process: under torchrun it
    joins the process group first (joined: True, and `leave_world` leaves
    it); in a group the rank's device and the ("data", "model") mesh with
    `model_axis`; else the device as given, no backend, no mesh (and a model
    axis above 1 is refused: one rank does not split)."""
    joined = not dist.is_initialized() and under_torchrun()
    if joined:
        initialize_multihost(device=device)
    if not dist.is_initialized():
        check_model_axis(model_axis, 1)
        return device, None, None, False
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device, dist.get_backend(), make_mesh(model_axis=model_axis,
                                                 device_type=device.type), joined


def leave_world(joined: bool) -> None:
    """Leave the process group that `join_world` joined, after every rank got here."""
    if joined:
        dist.barrier()
        dist.destroy_process_group()


def model_axis_of(config) -> int:
    """`MESH.MODEL_AXIS` of a `--cfg` config (1 without one)."""
    return int(1 if config is None else config.select(MODEL_AXIS_KEY, 1))


def batch_sharding(mesh) -> Tuple[int, int]:
    """(this rank's coordinate on the data axis, rank // model axis; the
    axis' size); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("data"), mesh.size(0)


def rows(x, shard: Tuple[int, int]):
    """The shard's contiguous rows `[r B / W, (r + 1) B / W)` of `x`; raises
    when W does not divide B, as a batch-sharded `NamedSharding` does."""
    rank, size = shard
    if size == 1:
        return x
    n = len(x)
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over {size} ranks")
    return x[rank * n // size:(rank + 1) * n // size]


def shard_batch(mesh, batch: Dict) -> Dict:
    """This rank's rows of every entry of a host batch (arrays, tensors,
    caption lists; nested dicts walked); the batch itself without a mesh."""
    shard = batch_sharding(mesh)
    if shard[1] == 1:
        return batch
    return {k: shard_batch(mesh, v) if isinstance(v, dict)
            else rows(v, shard) if isinstance(v, (np.ndarray, torch.Tensor, list, tuple)) else v
            for k, v in batch.items()}


def valid_rows(n_valid: int, batch_size: int, shard: Tuple[int, int]) -> int:
    """How many of a shard's rows lie before a padded batch's `n_valid`."""
    rank, size = shard
    per = batch_size // size
    return max(0, min(n_valid - rank * per, per))


def replicated(module: nn.Module, device: torch.device, group=None) -> nn.Module:
    """`module` under `DistributedDataParallel` over `group` (the world by
    default; a rank's data-axis group once its parameters are sharded over
    the model axis, whose ranks hold different slices): its construction
    broadcasts the group's first rank's parameters and buffers to the
    group, and each backward all-reduces (averages) the gradients of the
    parameters that require them. Buffers are not broadcast again each
    step: none of the systems' buffers changes in training. Every trainable
    parameter gets a gradient in every step (frozen subtrees have
    `requires_grad=False`, which DDP leaves out), so DDP does not search
    the graph for unused ones."""
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False, process_group=group)


def _collective_device() -> torch.device:
    """Where a collective's tensor must live: the card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks (one all-reduce); `x` itself at world 1."""
    if process_rank()[1] == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()


def allreduce_metric_sums(sums: Dict[str, float], counts: Dict[str, int],
                          keys: Sequence[str] = ()) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Sum per-rank metric accumulators over the ranks, so that every rank
    computes the means of the whole set (Lightning's `sync_dist=True`).

    One `all_reduce` of a float64 vector [sums; counts] over a fixed, sorted
    key set: `keys` (the metric's own) together with the keys present. A
    rank whose shard filtered out every sequence has no key of its own; the
    keys given pre-seed it with zeros, so the vectors align, and a key of
    them that no rank counted is dropped, as one process would have none.
    Every other key must be present on every rank. The JAX
    package gathers in float32; float64 keeps the sharded means equal to
    one process's. At world 1 a copy of the input."""
    if process_rank()[1] == 1:
        return dict(sums), dict(counts)
    names = sorted(set(sums) | set(keys))
    vec = torch.tensor([float(sums.get(k, 0.0)) for k in names]
                       + [float(counts.get(k, 0)) for k in names],
                       dtype=torch.float64, device=_collective_device())
    dist.all_reduce(vec)
    total = vec.cpu().tolist()
    n = len(names)
    out_sums, out_counts = {}, {}
    for i, k in enumerate(names):
        count = int(round(total[n + i]))
        if count or k not in keys:
            out_sums[k], out_counts[k] = total[i], count
    return out_sums, out_counts
