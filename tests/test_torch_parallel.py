"""Data parallelism (`seeme_tpu_torch/parallel/`) against the JAX package's
data-parallel step on the conftest's 8-device CPU mesh.

The port's ranks run in spawned processes over gloo
(`torch_parallel_worker.py`), at a small size (d=32, 3 layers, 64 points,
dropout 0) on a global batch of 8. Both packages get the same weights (the
port's, through `tools/convert_checkpoint.py`) and the same global draws
(`torch_train_common.py::jax_draws`, re-derived from the JAX step's own
keys); each rank takes its rows of the batch and of the draws, and DDP
averages its gradients. Tolerances: the first loss within 1e-5 relative,
its gradients within 1e-5 x each tensor's max |g|, five-step loss
trajectories within 1e-4, parameters bitwise equal across the ranks.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from seeme_tpu.parallel import allreduce_metric_sums as j_allreduce_metric_sums
from seeme_tpu.parallel.mesh import batch_sharding as j_batch_sharding
from seeme_tpu.parallel.mesh import make_mesh as j_make_mesh
from seeme_tpu.train.loop import make_train_step
from seeme_tpu.train.state import create_train_state, make_optimizer as j_make_optimizer
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.humanml import SyntheticT2MDataset
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.parallel import infer_param_shardings, make_mesh, shard_params
from seeme_tpu_torch.parallel.mesh import check_model_axis, rows, valid_rows
from seeme_tpu_torch.nn.init import perturb_parameters_
from torch_parallel_worker import build_library, ddp_steps, metric_sums, run_world, spawn
from torch_train_common import BOTH, GRAD_FLOOR, JSystem, JConfig, SMALL, T, jax_draws, \
    jax_loss_and_grads, jax_params
from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

GLOBAL_B, POINTS, STEPS = 8, 64, 5
OPT = dict(lr=1e-3, step_size_epochs=2, gamma=0.2, steps_per_epoch=2)
LOSS_RTOL, GRAD_RTOL, TRAJ_RTOL = 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module", params=["vae", "diffusion"])
def reference(request):
    """The JAX package's data-parallel step over the 8-device mesh (five
    steps from `make_train_step(mesh=make_mesh())`, the first step's
    gradients on the batch-sharded batch) and the inputs the port's ranks
    read."""
    stage = request.param
    data = SyntheticEgoDataset(GLOBAL_B, T, scene_points=POINTS, seed=0)
    kw = dict(condition=() if stage == "vae" else BOTH, **SMALL)
    system = SeeMeSystem(SeeMeConfig(**kw), synthetic_smpl(256), data.mean, data.std,
                         device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    jsystem = JSystem(JConfig(**kw), j_synthetic_smpl(256), data.mean, data.std)
    params = jax_params(system)
    nb = data.batch(0, GLOBAL_B)
    if stage == "diffusion":  # the cached route of the CLI's stage 2
        nb["scene_feats"] = np.array(jsystem.scene_features(params, jax.numpy.asarray(nb["scene"])))
    else:
        nb.pop("scene")
    mesh = j_make_mesh()
    assert mesh.devices.size == 8
    jb = jax.device_put({k: jax.numpy.asarray(v) for k, v in nb.items()}, j_batch_sharding(mesh))
    jopt = j_make_optimizer(stage, params, **OPT)
    jstep = make_train_step(jsystem, stage, jopt, mesh=mesh)
    state = create_train_state(params, jopt, jax.random.PRNGKey(3))
    rng = state.rng
    draws, losses = [], []
    for count in range(STEPS):
        rng, step_rng = jax.random.split(rng)
        draws.append(jax_draws(jsystem, stage, jb, step_rng))
        if count == 0:
            (loss0, _), jgrads = jax_loss_and_grads(jsystem, stage)(params, jb, step_rng)
        state, terms = jstep(state, jb)
        losses.append(float(terms["total"]))
    z_init = np.random.RandomState(5).randn(GLOBAL_B, 1, SMALL["scene_feat_dim"]) \
        .astype(np.float32)
    spec = {"stage": stage, "steps": STEPS, "optimizer": OPT, "config": kw}
    inputs = {"spec": json.dumps(spec), "mean": data.mean, "std": data.std,
              "z_init": z_init, **{f"b_{k}": v for k, v in nb.items()},
              **{f"sd_{k}": v.detach().numpy() for k, v in system.state_dict().items()},
              **{f"d{i}_{k}": v.numpy() for i, d in enumerate(draws) for k, v in d.items()}}
    return {"stage": stage, "inputs": inputs, "loss0": float(loss0), "losses": losses,
            "grads": from_jax_params(jax.tree.map(np.asarray, jgrads))}


@pytest.mark.parametrize("world", [2, 4])
def test_ddp_steps_match_jax_data_parallel(reference, world, tmp_path):
    """World 2 and 4 against the JAX 8-device data-parallel step: the first
    loss, every trainable gradient (frozen tensors get none), the five-step
    trajectory; parameters bitwise equal across the ranks; DDP's broadcast
    replaced the kernel operands a rank cached of its own weights."""
    out = str(tmp_path)
    np.savez(os.path.join(out, "inputs.npz"), **reference["inputs"])
    run_world(ddp_steps, world, out)
    ranks = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(world)]
    got = ranks[0]
    np.testing.assert_allclose(got["losses"][0], reference["loss0"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], reference["losses"], rtol=TRAJ_RTOL)
    grads = {k[2:] for k in got.files if k.startswith("g_")}
    trainable = ("vae.",) if reference["stage"] == "vae" else ("denoiser.", "output_scene.")
    assert grads and all(k.startswith(trainable) for k in grads), sorted(grads)[:5]
    for name in grads:
        g = reference["grads"][name].numpy()
        np.testing.assert_allclose(got[f"g_{name}"], g, rtol=0, err_msg=name,
                                   atol=max(GRAD_RTOL * float(np.abs(g).max()), GRAD_FLOOR))
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["losses"], got["losses"])
        for k in got.files:
            if k.startswith("p_"):
                np.testing.assert_array_equal(other[k], got[k], err_msg=k)
    # each rank sampled its own rows: rank r's sample after the broadcast is
    # what rank 0's weights give on those rows, and a perturbed rank's
    # sample before it differed
    for r, other in enumerate(ranks[1:], start=1):
        assert not np.array_equal(other["before"], other["after"]), r


def test_ddp_broadcast_rebuilds_kernel_operands(tmp_path):
    """After DDP's broadcast every rank samples with rank 0's weights: a
    rank that cached the kernel operands of its own (perturbed) weights
    gives, on the same rows, what a fresh system with rank 0's weights
    gives (the operands were made again from the broadcast weights)."""
    data = SyntheticEgoDataset(GLOBAL_B, T, scene_points=POINTS, seed=0)
    kw = dict(condition=BOTH, **SMALL)
    system = SeeMeSystem(SeeMeConfig(**kw), synthetic_smpl(256), data.mean, data.std,
                         device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    nb = data.batch(0, GLOBAL_B)
    z_init = np.random.RandomState(5).randn(GLOBAL_B, 1, SMALL["scene_feat_dim"]) \
        .astype(np.float32)
    spec = {"stage": "diffusion", "steps": 0, "optimizer": OPT, "config": kw}
    out = str(tmp_path)
    np.savez(os.path.join(out, "inputs.npz"), spec=json.dumps(spec), mean=data.mean,
             std=data.std, z_init=z_init, **{f"b_{k}": v for k, v in nb.items()},
             **{f"sd_{k}": v.detach().numpy() for k, v in system.state_dict().items()})
    run_world(ddp_steps, 2, out)
    batch = {k: rows(v, (1, 2)) for k, v in to_torch(nb, "cpu").items()}
    want = system.sample_from_cond(system.encode_conditioning(batch),
                                   z_init=rows(torch.as_tensor(z_init), (1, 2))).numpy()
    rank1 = np.load(os.path.join(out, "rank1.npz"))
    np.testing.assert_array_equal(rank1["after"], want)
    assert float(np.abs(rank1["before"] - want).max()) > 1e-3


@functools.lru_cache(maxsize=None)
def _systems():
    ego = SyntheticEgoDataset(GLOBAL_B, T, scene_points=16, seed=0)
    t2m = SyntheticT2MDataset(GLOBAL_B, 24, 8, nfeats=263, text_dim=48, seed=0)
    r = np.random.RandomState(0)
    a2m = {"motion": r.randn(GLOBAL_B, 16, 150).astype(np.float32) * 0.3,
           "action": r.randint(0, 12, GLOBAL_B).astype(np.int32),
           "length": np.full(GLOBAL_B, 16, np.int32)}
    tiny = dict(latent_dim=(1, 32), ff_size=16, num_layers=3)
    return {
        "ego-cfg2.5": (SeeMeSystem(SeeMeConfig(condition=BOTH, guidance_scale=2.5,
                                               scene_points=16, scene_feat_dim=32, **tiny),
                                   synthetic_smpl(256), ego.mean, ego.std, device="cpu"),
                       ego.batch(0, GLOBAL_B)),
        "t2m": (T2MSystem(T2MConfig(text_encoded_dim=48, max_len=24, min_len=8, **tiny),
                          t2m.mean, t2m.std, device="cpu"), t2m.batch(0, GLOBAL_B)),
        "a2m": (A2MSystem(A2MConfig(num_frames=16, **tiny), synthetic_smpl(256),
                          device="cpu"), a2m),
    }


@pytest.mark.parametrize("name", ["ego-cfg2.5", "t2m", "a2m"])
@pytest.mark.parametrize("stage", ["vae", "diffusion"])
@pytest.mark.parametrize("world", [2, 4])
def test_loss_draws_of_a_shard_are_rows_of_the_global_draws(name, stage, world):
    """Each system's `loss_draws` on a rank's rows with `shard` equals the
    rank's rows of the one-process draws on the whole batch, from a
    generator seeded alike (noise, timesteps, CFG masks, text / action
    drops)."""
    system, nb = _systems()[name]
    batch = to_torch(nb, "cpu")
    whole = system.loss_draws(stage, batch, torch.Generator().manual_seed(7))
    for rank in range(world):
        mine = system.loss_draws(stage, {k: rows(v, (rank, world)) for k, v in batch.items()},
                                 torch.Generator().manual_seed(7), shard=(rank, world))
        assert mine.keys() == whole.keys()
        for k, v in whole.items():
            assert torch.equal(mine[k], rows(v, (rank, world))), (name, stage, k)


def _jax_sums(per_rank):
    """The JAX package's `allreduce_metric_sums` over `per_rank` (sums,
    counts) pairs, its process gather replaced by the stack of every rank's
    vector (as built by the function itself); the rank with no key
    pre-seeded, as its docstring asks."""
    from unittest import mock

    from jax.experimental import multihost_utils

    keys = sorted(set().union(*(s for s, _ in per_rank)))
    seeded = [({k: s.get(k, 0.0) for k in keys}, {k: c.get(k, 0) for k in keys})
              for s, c in per_rank]
    vecs = []
    with mock.patch.object(jax, "process_count", lambda: len(per_rank)):
        with mock.patch.object(multihost_utils, "process_allgather",
                               lambda v: vecs.append(v) or v[None]):
            for s, c in seeded:
                j_allreduce_metric_sums(s, c)
        with mock.patch.object(multihost_utils, "process_allgather",
                               lambda v: np.stack(vecs)):
            return j_allreduce_metric_sums(*seeded[0])


@pytest.mark.parametrize("world", [2, 4])
def test_allreduce_metric_sums_matches_jax(world, tmp_path):
    """The ranks' summed accumulators against the JAX function's (float32
    there, float64 here), with the last rank's shard filtered out whole (no
    key); the synced means equal one process's sums over every sequence;
    `shard_batch` gives rank r rows [r B / W, (r + 1) B / W) and refuses a
    batch W does not divide."""
    rng = np.random.RandomState(world)
    keys = ("MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR", "ACCL")
    values = [rng.rand(rng.randint(1, 5), 4) * 100 for _ in range(world - 1)] + [np.zeros((0, 4))]
    per_rank = [({k: float(v[:, i].sum()) for i, k in enumerate(keys) if len(v)},
                 {k: len(v) for k in keys if len(v)}) for v in values]
    with open(tmp_path / "sums.json", "w") as f:
        json.dump([{"sums": s, "counts": c} for s, c in per_rank], f)
    run_world(metric_sums, world, str(tmp_path))
    out = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(world)]
    j_sums, j_counts = _jax_sums(per_rank)
    every = np.concatenate(values)
    for r, o in enumerate(out):
        assert [o[k] for k in ("sums", "counts", "means", "refusal")] == \
            [out[0][k] for k in ("sums", "counts", "means", "refusal")], r
        assert o["counts"] == j_counts == {k: len(every) for k in keys}
        for i, k in enumerate(keys):
            np.testing.assert_allclose(o["sums"][k], j_sums[k], rtol=1e-6)
            np.testing.assert_allclose(o["means"][k], every[:, i].mean(), rtol=1e-12)
        per = GLOBAL_B // world
        assert o["rows"] == list(range(r * per, (r + 1) * per)) == o["nested"]
        assert o["text"] == [str(i) for i in o["rows"]]
        assert o["refusal"] == f"a batch of 5 rows does not split over {world} ranks"


def test_rows_and_valid_rows():
    """`rows` is the identity at world 1 and refuses an uneven split;
    `valid_rows` counts a shard's rows before a padded batch's end."""
    x = np.arange(8)
    assert rows(x, (0, 1)) is x
    np.testing.assert_array_equal(rows(x, (1, 4)), [2, 3])
    with pytest.raises(ValueError, match="6 rows does not split over 4 ranks"):
        rows(np.arange(6), (0, 4))
    assert [valid_rows(5, 8, (r, 2)) for r in range(2)] == [4, 1]
    assert [valid_rows(3, 8, (r, 4)) for r in range(4)] == [2, 1, 0, 0]
    assert valid_rows(8, 8, (0, 1)) == 8


def test_model_axis_above_one_is_refused_by_name():
    """In one process (one rank) `make_mesh` and `check_model_axis` refuse a
    model axis above 1, naming MESH.MODEL_AXIS, as the JAX `make_mesh`
    asserts on one device; a model axis that divides the world is taken.
    The parameter rules replicate everything at model size 1 and shard a
    Linear 512 wide on its output dim at 2."""
    with pytest.raises(ValueError, match="MESH.MODEL_AXIS=2 does not divide the 1 rank"):
        check_model_axis(2, 1)
    with pytest.raises(ValueError, match="MESH.MODEL_AXIS=4"):
        make_mesh(model_axis=4)
    with pytest.raises(ValueError, match="MESH.MODEL_AXIS=3"):
        check_model_axis(3, 4)
    assert check_model_axis("2", 4) == 2 and check_model_axis("1", 1) == 1
    module = torch.nn.Linear(3, 512)
    assert infer_param_shardings(module, None) == {"weight": None, "bias": None}
    assert infer_param_shardings(module, 2) == {"weight": 0, "bias": None}
    assert shard_params(module, None) is module


def test_ranks_started_together_build_the_kernels_once(tmp_path):
    """Two processes that load the kernel library at once (the compile
    stubbed: no nvcc here) get the same library path, and the file lock in
    the build dir lets only one of them build it."""
    spawn(build_library, 2, str(tmp_path))
    loaded = {open(tmp_path / f"loaded{i}.txt").read() for i in range(2)}
    assert len(loaded) == 1
    path = loaded.pop()
    assert path.startswith(str(tmp_path / "_build" / "libseeme_kernels_")) and os.path.exists(path)
    assert len(open(tmp_path / "builds.txt").read().split()) == 1
