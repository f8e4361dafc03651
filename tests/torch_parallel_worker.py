"""Rank processes of the data-parallel tests (`test_torch_parallel*.py`).

`run_world(fn, world, ...)` spawns `world` processes (`torch.multiprocessing`,
the spawn start method); each runs `fn(rank, world, ...)` on the CPU after
joining a gloo process group through a file rendezvous, so parallel test
workers never race for a port. These functions import only
`seeme_tpu_torch`, torch and numpy, and write `.npz` / `.json` files under
the directory they are given, which the pytest process compares with the
JAX package and with one process.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.multiprocessing as mp


def run_world(fn, world: int, out: str, *args) -> None:
    """`fn(rank, world, out, *args)` in `world` processes over gloo; raises
    when any of them fails."""
    os.makedirs(out, exist_ok=True)
    rdv = os.path.join(out, "rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    mp.start_processes(_entry, args=(fn, world, out, rdv, args), nprocs=world, join=True,
                       start_method="spawn")


def spawn(fn, n: int, out: str) -> None:
    """`fn(i, out)` in `n` processes started together, with no process group."""
    mp.start_processes(fn, args=(out,), nprocs=n, join=True, start_method="spawn")


def build_library(i: int, out: str) -> None:
    """`ops/_build.load_library` with its build dir in `out` and the compile
    stubbed (half a second, then an empty library file; each build appends
    a line to `builds.txt`); writes the library path it loaded to
    `loaded<i>.txt`."""
    import time
    from pathlib import Path

    from seeme_tpu_torch.ops import _build

    def fake_build(path):
        time.sleep(0.5)
        with open(os.path.join(out, "builds.txt"), "a") as f:
            f.write(f"{i}\n")
        path.write_bytes(b"")
        return "stub"

    _build.BUILD_DIR = Path(out) / "_build"
    _build._build = fake_build
    _build.open_library = str
    with open(os.path.join(out, f"loaded{i}.txt"), "w") as f:
        f.write(_build.load_library())


def _entry(rank, fn, world, out, rdv, args):
    from seeme_tpu_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    try:
        fn(rank, world, out, *args)
    finally:
        torch.distributed.destroy_process_group()


def small_system(kw: dict, mean, std):
    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem

    cfg = SeeMeConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})
    return SeeMeSystem(cfg, synthetic_smpl(256), mean, std, device="cpu", seed=1)


def ddp_steps(rank: int, world: int, out: str) -> None:
    """The port's data-parallel train steps on `inputs.npz`: the system from
    its weights (rank > 0 perturbs its own first, and caches the kernel
    operands of those weights, which DDP's broadcast must replace), then
    `steps` updates of the stage through `StageLoss` under DDP, each on the
    rank's rows of the batch with the rank's rows of the step's global
    draws. Writes `rank<r>.npz`: the losses, the first step's gradients, the
    final parameters, and a DDIM sample before and after the broadcast."""
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.parallel.mesh import make_mesh, replicated, rows, batch_sharding
    from seeme_tpu_torch.train.loop import StageLoss, train_step
    from seeme_tpu_torch.train.state import make_optimizer

    inputs = np.load(os.path.join(out, "inputs.npz"))
    spec = json.loads(str(inputs["spec"]))
    stage, steps = spec["stage"], spec["steps"]
    system = small_system(spec["config"], inputs["mean"], inputs["std"])
    system.load_state_dict({k[3:]: torch.as_tensor(inputs[k]) for k in inputs.files
                            if k.startswith("sd_")})
    shard = batch_sharding(make_mesh(device_type="cpu"))
    assert shard == (rank, world), shard
    batch = to_torch({k[2:]: inputs[k] for k in inputs.files if k.startswith("b_")}, "cpu")
    batch = {k: rows(v, shard) for k, v in batch.items()}
    z_init = rows(torch.as_tensor(inputs["z_init"]), shard)

    def sample():
        return system.sample_from_cond(system.encode_conditioning(batch), z_init=z_init).numpy()

    if rank:
        perturb_parameters_(system, torch.Generator().manual_seed(100 + rank))
    before = sample()  # caches this rank's kernel operands
    optimizer, schedule = make_optimizer(stage, system, **spec["optimizer"])
    model = replicated(StageLoss(system, stage), torch.device("cpu"))
    after = sample()
    losses, grads = [], {}
    for count in range(steps):
        draws = {k.split("_", 1)[1]: torch.as_tensor(inputs[k]) for k in inputs.files
                 if k.startswith(f"d{count}_")}
        terms = train_step(system, stage, optimizer, schedule, count, batch,
                           draws={k: rows(v, shard) for k, v in draws.items()}, model=model)
        losses.append(terms["total"])
        if count == 0:
            grads = {n: p.grad.numpy().copy() for n, p in system.named_parameters()
                     if p.grad is not None}
    np.savez(os.path.join(out, f"rank{rank}.npz"), losses=np.asarray(losses),
             before=before, after=after, **{f"g_{k}": v for k, v in grads.items()},
             **{f"p_{k}": v.detach().numpy() for k, v in system.state_dict().items()})


def metric_sums(rank: int, world: int, out: str) -> None:
    """`allreduce_metric_sums` of `sums.json`'s entry for this rank (with the
    ego metric's keys), `EgoMetric.compute(sync=True)` of those accumulators,
    and `shard_batch` of an 8-row batch and of a 5-row one; writes
    `rank<r>.json`."""
    from seeme_tpu_torch.eval.metrics import FILTERED_KEYS, EgoMetric
    from seeme_tpu_torch.parallel import allreduce_metric_sums, make_mesh, shard_batch

    with open(os.path.join(out, "sums.json")) as f:
        mine = json.load(f)[rank]
    sums, counts = allreduce_metric_sums(mine["sums"], mine["counts"], FILTERED_KEYS)
    metric = EgoMetric(sums=dict(mine["sums"]), counts=dict(mine["counts"]))
    mesh = make_mesh(device_type="cpu")
    rows8 = shard_batch(mesh, {"x": np.arange(8), "text": [str(i) for i in range(8)],
                               "nested": {"y": torch.arange(8)}})
    try:
        shard_batch(mesh, {"x": np.arange(5)})
        refusal = None
    except ValueError as e:
        refusal = str(e)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"sums": sums, "counts": counts, "means": metric.compute(sync=True),
                   "rows": rows8["x"].tolist(), "text": rows8["text"],
                   "nested": rows8["nested"]["y"].tolist(), "refusal": refusal}, f)


def train_cli(rank: int, world: int, out: str, runs: list) -> None:
    """`seeme_tpu_torch.train`'s `main` for each argv of `runs`, one after
    the other in the same process group; writes `rank<r>_<i>.npz` for each:
    each step's total, the validations' totals, the checkpoints named, and
    the final parameters."""
    from seeme_tpu_torch.train.__main__ import main

    for i, argv in enumerate(runs):
        trainer = main(argv)
        np.savez(os.path.join(out, f"rank{rank}_{i}.npz"),
                 steps=np.asarray([s["total"] for r in trainer.history for s in r["steps"]]),
                 val=np.asarray([r["val"]["total"] for r in trainer.history if "val" in r]),
                 checkpoints=np.asarray(trainer.checkpoints),
                 **{f"p_{k}": v.detach().numpy()
                    for k, v in trainer.system.state_dict().items()})


def eval_cli(rank: int, world: int, out: str, argv: list) -> None:
    """`seeme_tpu_torch.test`'s `main(argv)`; writes `rank<r>.json` with its
    replications' metrics."""
    from seeme_tpu_torch.test.__main__ import main

    result = main(argv)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"replications": result["replications"]}, f)


def model_axis_steps(rank: int, world: int, out: str, model_axis: int) -> None:
    """`shard_params` over a (world / m, m) mesh on `inputs.npz`, against
    the same system replicated: each from the inputs' weights, each takes
    one stage-2 update through `StageLoss` under DDP over the rank's
    data-axis group, on the rank's rows of the batch and of the global
    draws; the sharded one also samples (DDIM) before and after sharding
    and after its step. Writes `rank<r>.npz`: both losses, the samples, the
    whole parameters after each step (the sharded ones gathered), and the
    element counts of the stored parameters and of AdamW's moments, sharded
    and whole."""
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.ops import module_state
    from seeme_tpu_torch.parallel import infer_param_shardings, make_mesh, shard_params
    from seeme_tpu_torch.parallel.mesh import batch_sharding, replicated, rows
    from seeme_tpu_torch.train.loop import StageLoss, train_step
    from seeme_tpu_torch.train.state import make_optimizer

    inputs = np.load(os.path.join(out, "inputs.npz"))
    spec = json.loads(str(inputs["spec"]))
    mesh = make_mesh(model_axis=model_axis, device_type="cpu")
    shard = batch_sharding(mesh)
    assert shard == (rank // model_axis, world // model_axis), shard
    batch = {k: rows(v, shard) for k, v in to_torch(
        {k[2:]: inputs[k] for k in inputs.files if k.startswith("b_")}, "cpu").items()}
    draws = {k[3:]: rows(torch.as_tensor(inputs[k]), shard) for k in inputs.files
             if k.startswith("d0_")}
    z_init = rows(torch.as_tensor(inputs["z_init"]), shard)

    def fresh():
        system = small_system(spec["config"], inputs["mean"], inputs["std"])
        system.load_state_dict({k[3:]: torch.as_tensor(inputs[k]) for k in inputs.files
                                if k.startswith("sd_")})
        return system

    def step(system):
        optimizer, schedule = make_optimizer("diffusion", system, **spec["optimizer"])
        model = replicated(StageLoss(system, "diffusion"), torch.device("cpu"),
                           group=mesh.get_group("data"))
        return optimizer, train_step(system, "diffusion", optimizer, schedule, 0, batch,
                                     draws=draws, model=model)["total"]

    twin = fresh()
    _, twin_loss = step(twin)
    system = fresh()

    def sample():
        return system.sample_from_cond(system.encode_conditioning(batch), z_init=z_init).numpy()

    whole = sample()
    sharded = {n for n, d in infer_param_shardings(system, mesh).items() if d is not None}
    shard_params(system, mesh)
    gathered = sample()
    optimizer, loss = step(system)
    stepped = sample()
    stored = {"sharded": 0, "whole": 0}
    moments = {"sharded": 0, "whole": 0}
    for n, p in system.named_parameters():
        kind = "sharded" if ".parametrizations." in n else "whole"
        stored[kind] += p.numel()
        state = optimizer.state.get(p, {})
        if "exp_avg" in state:
            moments[kind] += state["exp_avg"].numel()
    np.savez(os.path.join(out, f"rank{rank}.npz"), loss=loss, twin_loss=twin_loss, whole=whole,
             gathered=gathered, stepped=stepped, sharded=np.asarray(sorted(sharded)),
             stored=np.asarray([stored["sharded"], stored["whole"]]),
             moments=np.asarray([moments["sharded"], moments["whole"]]),
             **{f"p_{k}": v.numpy() for k, v in module_state(system).items()},
             **{f"r_{k}": v.detach().numpy() for k, v in twin.state_dict().items()})
