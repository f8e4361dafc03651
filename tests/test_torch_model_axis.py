"""The model axis of `seeme_tpu_torch/parallel/` (`MESH.MODEL_AXIS`,
`infer_param_shardings`, `shard_params`) against the JAX package's
`seeme_tpu/parallel/shardings.py` and against one replicated process.

The rule set is held to the JAX rule on the same configs (the JAX side on
`jax.eval_shape` of `init_params`, its flags carried onto the port's names
through `convert.py::from_jax_params`). The sharded step runs in spawned
gloo ranks (`torch_parallel_worker.py`) at (1, 2) and (2, 2), as
`tests/test_end_to_end.py:169-197` runs the JAX one: the stage-2 loss within
1e-4 of the replicated loss, the parameters after one AdamW step within
1e-5 of each tensor's max, half the storage and half the moments of the
sharded tensors on each rank, and the DDIM sample bitwise unchanged by
sharding. The train CLI at `MESH.MODEL_AXIS=2` equals one process; the
test CLI runs at `MESH.MODEL_AXIS=2`, as `test.py` ignores the key.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from seeme_tpu.models.a2m import A2MConfig as JA2MConfig
from seeme_tpu.models.a2m import A2MSystem as JA2MSystem
from seeme_tpu.models.seeme import SeeMeConfig as JConfig
from seeme_tpu.models.seeme import SeeMeSystem as JSystem
from seeme_tpu.models.t2m import T2MConfig as JT2MConfig
from seeme_tpu.models.t2m import T2MSystem as JT2MSystem
from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.parallel import infer_param_shardings as j_infer_param_shardings
from seeme_tpu.parallel.mesh import make_mesh as j_make_mesh
from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.nn.init import perturb_parameters_
from seeme_tpu_torch.parallel import infer_param_shardings
from seeme_tpu_torch.test.__main__ import main as eval_main
from seeme_tpu_torch.train.__main__ import main as train_main
from seeme_tpu_torch.train.loop import train_step
from seeme_tpu_torch.train.state import make_optimizer
from torch_parallel_worker import model_axis_steps, run_world, train_cli
from torch_train_common import BOTH, T
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLD = os.path.join(ROOT, "configs", "config_mld_egobody.yaml")
TINY = ["DEBUG=true", "model.latent_dim=[1,32]", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32", "LOGGER.VAL_EVERY_STEPS=1"]
GLOBAL_B = 8
OPT = dict(lr=1e-3, step_size_epochs=2, gamma=0.2, steps_per_epoch=2)
LOSS_RTOL, PARAM_TOL = 1e-4, 1e-5

RULE_CASES = {
    # the JAX test's config (`tests/test_end_to_end.py:174`), its widths and defaults
    "ego-e2e": ("ego", dict(motion_length=8, scene_points=64, ff_size=512)),
    "ego": ("ego", {}),
    "ego-image": ("ego", dict(condition=("interactee", "scene", "image"), scene_points=64)),
    "ego-latent512": ("ego", dict(latent_dim=(1, 512), scene_points=64, num_layers=3)),
    "t2m": ("t2m", {}),
    "t2m-wide": ("t2m", dict(ff_size=1024)),
    "t2m-dec-novae": ("t2m", dict(ff_size=1024, arch="trans_dec", vae_type="no")),
    "a2m": ("a2m", {}),
    "a2m-wide": ("a2m", dict(ff_size=1024)),
}


def _fields(cls, cfg):
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k in names}


def _systems(kind, kw):
    """(the port's system, the JAX system's `init_params` shapes) of a config."""
    if kind == "ego":
        cfg = SeeMeConfig(**kw)
        system = SeeMeSystem(cfg, synthetic_smpl(256), np.zeros(cfg.nfeats, np.float32),
                             np.ones(cfg.nfeats, np.float32), device="cpu")
        jsystem = JSystem(JConfig(**_fields(JConfig, cfg)), j_synthetic_smpl(256),
                          np.zeros(cfg.nfeats, np.float32), np.ones(cfg.nfeats, np.float32))
    elif kind == "t2m":
        cfg = T2MConfig(**kw)
        system = T2MSystem(cfg, np.zeros(cfg.nfeats, np.float32), np.ones(cfg.nfeats, np.float32),
                           device="cpu")
        jsystem = JT2MSystem(JT2MConfig(**_fields(JT2MConfig, cfg)))
    else:
        cfg = A2MConfig(**kw)
        system = A2MSystem(cfg, synthetic_smpl(256), device="cpu")
        jsystem = JA2MSystem(JA2MConfig(**_fields(JA2MConfig, cfg)))
    return system, jax.eval_shape(jsystem.init_params, jax.random.PRNGKey(0))


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_set_matches_jax(case, model_axis):
    """The parameters `infer_param_shardings` shards are those the JAX rule
    shards on the same config (a tensor the converter stacks from several
    JAX kernels, such as `in_proj_weight` from q / k / v, is sharded when
    each of them is), each on the torch dim of the JAX last axis."""
    kind, kw = RULE_CASES[case]
    system, shapes = _systems(kind, kw)
    mesh = j_make_mesh(data_axis=8 // model_axis, model_axis=model_axis)
    specs = j_infer_param_shardings(shapes, mesh)
    flags = jax.tree.map(
        lambda s, sh: np.full(s.shape, float(bool(sh.spec) and sh.spec[-1] == "model"), np.float32),
        shapes, specs)
    if kind == "a2m":
        flags["embed_action"] = {"params": {"action_embedding": flags["embed_action"]["params"]
                                            ["action_embedding"]}}
    want_sd = from_jax_params(flags)
    got = infer_param_shardings(system, model_axis)
    names = [n for n, _ in system.named_parameters()]
    assert set(got) == set(names)
    want = set()
    for n in names:
        v = want_sd[n]
        assert bool((v == v.flatten()[0]).all()), f"{n}: partly sharded components"
        if float(v.flatten()[0]):
            want.add(n)
    assert {n for n, d in got.items() if d is not None} == want
    assert want or case in ("t2m", "a2m")  # the shipped T2M / a2m widths shard nothing
    params = dict(system.named_parameters())
    for n in want:
        d = got[n]
        assert params[n].shape[d] % model_axis == 0 and params[n].shape[d] >= 512, n
    assert all(d is None for d in infer_param_shardings(system, None).values())


@pytest.fixture(scope="module")
def step_inputs():
    """The stage-2 inputs the ranks read, and the replicated step on them in
    this process: the loss, the parameters after one AdamW update, the DDIM
    sample before and after it."""
    data = SyntheticEgoDataset(GLOBAL_B, T, scene_points=64, seed=0)
    kw = dict(condition=BOTH, latent_dim=(1, 32), ff_size=512, num_layers=3, scene_points=64,
              scene_feat_dim=32, dropout=0.0)
    system = SeeMeSystem(SeeMeConfig(**kw), synthetic_smpl(256), data.mean, data.std,
                         device="cpu", seed=1)
    perturb_parameters_(system, torch.Generator().manual_seed(2))
    sd = {k: v.detach().numpy().copy() for k, v in system.state_dict().items()}
    nb = data.batch(0, GLOBAL_B)
    batch = to_torch(nb, "cpu")
    draws = system.loss_draws("diffusion", batch, torch.Generator().manual_seed(3))
    z_init = np.random.RandomState(5).randn(GLOBAL_B, 1, 32).astype(np.float32)

    def sample():
        return system.sample_from_cond(system.encode_conditioning(batch),
                                       z_init=torch.as_tensor(z_init)).numpy()

    before = sample()
    optimizer, schedule = make_optimizer("diffusion", system, **OPT)
    loss = train_step(system, "diffusion", optimizer, schedule, 0, batch, draws=draws)["total"]
    spec = {"config": kw, "optimizer": OPT}
    inputs = {"spec": json.dumps(spec), "mean": data.mean, "std": data.std, "z_init": z_init,
              **{f"b_{k}": v for k, v in nb.items()}, **{f"sd_{k}": v for k, v in sd.items()},
              **{f"d0_{k}": v.numpy() for k, v in draws.items()}}
    return {"inputs": inputs, "loss": loss, "before": before, "after": sample(),
            "params": {k: v.detach().numpy() for k, v in system.state_dict().items()}}


@pytest.mark.parametrize("world,model_axis", [(2, 2), (4, 2)], ids=["1x2", "2x2"])
def test_sharded_step_matches_replicated(step_inputs, world, model_axis, tmp_path):
    """One stage-2 AdamW step with `shard_params` on a (world / 2, 2) mesh,
    against the same step with the parameters replicated on that mesh (DDP
    over the data axis) and against one process on the whole batch: the
    loss within 1e-4 of either, every parameter within 1e-5 of its tensor's
    max of the replicated step's, alike on every rank; each rank stores half
    of each sharded tensor and keeps half its moments; the DDIM sample from
    the gathered operands is bitwise the unsharded one, and after the step
    it follows the update (the kernel-layout copies were made again)."""
    out = str(tmp_path)
    np.savez(os.path.join(out, "inputs.npz"), **step_inputs["inputs"])
    run_world(model_axis_steps, world, out, model_axis)
    ranks = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(world)]
    whole_sd = step_inputs["params"]
    per = GLOBAL_B // (world // model_axis)
    for r, x in enumerate(ranks):
        np.testing.assert_allclose(float(x["loss"]), float(x["twin_loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(x["loss"]), step_inputs["loss"], rtol=LOSS_RTOL)
        rows = slice((r // model_axis) * per, (r // model_axis + 1) * per)
        np.testing.assert_array_equal(x["whole"], step_inputs["before"][rows])
        np.testing.assert_array_equal(x["gathered"], x["whole"])
        np.testing.assert_allclose(x["stepped"], step_inputs["after"][rows], rtol=0,
                                   atol=1e-3 * float(np.abs(step_inputs["after"]).max()))
        assert not np.array_equal(x["stepped"], x["gathered"])
        keys = {k[2:] for k in x.files if k.startswith("p_")}
        assert keys == set(whole_sd) == {k[2:] for k in x.files if k.startswith("r_")}
        for k in keys:
            want = x[f"r_{k}"]
            np.testing.assert_allclose(x[f"p_{k}"], want, rtol=0, err_msg=k,
                                       atol=PARAM_TOL * max(float(np.abs(want).max()), 1e-30))
            np.testing.assert_array_equal(x[f"p_{k}"], ranks[0][f"p_{k}"], err_msg=k)
        sharded = list(x["sharded"])
        assert "denoiser.encoder.middle_block.ffn.linear1.weight" in sharded, sharded
        assert "proscene.scene_enc.fc_pos_0.weight" in sharded, sharded
        stored_sharded, _ = x["stored"]
        assert stored_sharded * model_axis == sum(int(np.prod(whole_sd[n].shape))
                                                  for n in sharded)
        trained = [n for n in sharded if n.startswith(("denoiser.", "output_scene."))]
        assert trained
        assert x["moments"][0] * model_axis == sum(int(np.prod(whole_sd[n].shape))
                                                   for n in trained)


def test_train_cli_model_axis_two_equals_one_process(tmp_path):
    """`--cfg ... MESH.MODEL_AXIS=2` at world 2, a (1, 2) mesh: both ranks
    take every row, DDP averages their equal gradients, so every step's
    loss, each validation and the parameters equal one process's, bitwise,
    on both ranks; the log names the mesh."""
    args = ["--cfg", MLD, "--device", "cpu", "--batch_size", "8", "--epochs", "2",
            "TRAIN.FEATURE_CACHE=true", "model.droupout=0.0", *TINY]
    run_world(train_cli, 2, str(tmp_path / "ranks"),
              [[*args, "MESH.MODEL_AXIS=2", "--out", str(tmp_path / "two")]])
    one = train_main([*args, "--out", str(tmp_path / "one")])
    want = [s["total"] for r in one.history for s in r["steps"]]
    assert len(want) == 8
    sd = one.system.state_dict()
    for r in range(2):
        x = np.load(tmp_path / "ranks" / f"rank{r}_0.npz")
        np.testing.assert_array_equal(x["steps"], want)
        np.testing.assert_array_equal(x["val"], [h["val"]["total"] for h in one.history])
        for k, v in sd.items():
            np.testing.assert_array_equal(x[f"p_{k}"], v.numpy(), err_msg=k)
    logs = [f for f in os.listdir(tmp_path / "two") if f.endswith("_train.log")]
    assert "world=2 backend=gloo mesh=1x2" in open(tmp_path / "two" / logs[0]).read()


def test_test_cli_runs_at_model_axis_two(tmp_path):
    """The test CLI reads no `MESH.MODEL_AXIS`, as `test.py` does not: at 2
    in one process it runs, and its metrics equal those at 1."""
    args = ["--cfg", MLD, "--device", "cpu", "--batch_size", "8", "TEST.SPLIT=val", *TINY]
    two = eval_main([*args, "MESH.MODEL_AXIS=2", "--out", str(tmp_path / "two")])
    one = eval_main([*args, "--out", str(tmp_path / "one")])
    assert two["replications"] == one["replications"] and len(one["replications"]) == 1
