"""Five training steps, resume and checkpoints of the port against the JAX
package (the helpers and the shared setup are in `torch_train_common.py`;
see `test_torch_train.py`).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from seeme_tpu.train.loop import _make_step_body
from seeme_tpu.train.state import create_train_state, make_optimizer as j_make_optimizer
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.train import checkpoint as ckpt
from seeme_tpu_torch.train.loop import train_step
from seeme_tpu_torch.train.state import make_optimizer
from torch_train_common import (
    B,
    batches,
    BOTH,
    build,
    jax_draws,
    POINTS,
    SMALL,
    T,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_five_train_steps_match_jax(stage):
    """Five whole train steps (the JAX step body with its own key splits,
    the port's `train_step` with those draws): loss trajectories within 1e-4
    relative."""
    data, system, jsystem, params = build(() if stage == "vae" else BOTH)
    tb, jb = batches(data, system, jsystem, params, cached=stage == "diffusion")
    kw = dict(lr=1e-3, step_size_epochs=2, gamma=0.2, steps_per_epoch=2)
    optimizer, schedule = make_optimizer(stage, system, **kw)
    jopt = j_make_optimizer(stage, params, **kw)
    jstep = jax.jit(_make_step_body(jsystem, stage, jopt))
    state = create_train_state(params, jopt, jax.random.PRNGKey(3))
    rng = state.rng
    ours, theirs = [], []
    for count in range(5):
        rng, step_rng = jax.random.split(rng)
        terms = train_step(system, stage, optimizer, schedule, count, tb,
                           draws=jax_draws(jsystem, stage, jb, step_rng))
        state, jterms = jstep(state, jb)
        ours.append(terms["total"])
        theirs.append(float(jterms["total"]))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


@pytest.mark.parametrize("stage", ["vae", "diffusion"])
def test_resume_is_bitwise(stage, tmp_path):
    """4 steps straight, against 2 steps, a checkpoint, a restore into a
    fresh system and 2 more: parameters and optimizer state bitwise equal
    (dropout on, so torch's default generator is restored too)."""
    data = SyntheticEgoDataset(B, T, scene_points=POINTS, seed=0)
    tb = to_torch(data.batch(0, B), "cpu")

    def fresh():
        cfg = dataclasses.replace(SeeMeConfig(**SMALL), dropout=0.1)
        system = SeeMeSystem(cfg, synthetic_smpl(256), data.mean, data.std, device="cpu", seed=1)
        optimizer, schedule = make_optimizer(stage, system, lr=1e-3, steps_per_epoch=2)
        return system, optimizer, schedule, torch.Generator().manual_seed(9)

    def run(parts, counts):
        for count in counts:
            train_step(*parts[:1], stage, parts[1], parts[2], count, tb, parts[3])

    torch.manual_seed(4)
    straight = fresh()
    run(straight, range(4))
    torch.manual_seed(4)
    first = fresh()
    run(first, range(2))
    path = ckpt.save_state(str(tmp_path), first[0], first[1], 2, 1, first[3])
    assert os.path.basename(path) == "2.pt"
    torch.rand(7)  # the restore must undo any later draw
    second = fresh()
    assert ckpt.restore_state(str(tmp_path), second[0], second[1], second[3]) == (2, 1)
    run(second, range(2, 4))
    for k, v in straight[0].state_dict().items():
        assert torch.equal(v, second[0].state_dict()[k]), k
    a, b = straight[1].state_dict()["state"], second[1].state_dict()["state"]
    assert a.keys() == b.keys()
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)


def test_pretrained_vae(tmp_path):
    """`load_pretrained_vae` grafts only `vae.*` from a stage-1 checkpoint,
    and raises on a checkpoint without it."""
    _, donor, _, _ = build(())
    optimizer, _ = make_optimizer("vae", donor)
    ckpt.save_state(str(tmp_path / "s1"), donor, optimizer, 7, 1)
    _, system, _, _ = build(BOTH, seed=5)
    before = {k: v.clone() for k, v in system.state_dict().items()}
    n = ckpt.load_pretrained_vae(str(tmp_path / "s1" / "checkpoints" / "latest"), system)
    assert n == len(donor.vae.state_dict())
    for k, v in system.state_dict().items():
        want = donor.state_dict()[k] if k.startswith("vae.") else before[k]
        assert torch.equal(v, want), k
    torch.save({"state_dict": {k: v for k, v in before.items() if not k.startswith("vae.")}},
               tmp_path / "no_vae.pt")
    with pytest.raises(KeyError, match="vae"):
        ckpt.load_pretrained_vae(str(tmp_path / "no_vae.pt"), system)


def test_checkpoint_paths(tmp_path):
    exp = tmp_path / "exp"
    (exp / "checkpoints").mkdir(parents=True)
    assert ckpt.latest_checkpoint_step(str(exp)) is None
    for step in (4, 12, 8):
        (exp / "checkpoints" / f"{step}.pt").write_bytes(b"")
    (exp / "checkpoints" / "12.pt.tmp").write_bytes(b"")
    assert ckpt.latest_checkpoint_step(str(exp)) == 12
    assert ckpt.resolve_latest(str(exp / "checkpoints" / "latest")) == str(exp / "checkpoints" / "12.pt")
    assert ckpt.resolve_latest(str(exp / "checkpoints" / "4.pt")) == str(exp / "checkpoints" / "4.pt")
    for spelling in (exp, exp / "checkpoints", exp / "checkpoints" / "8.pt",
                     exp / "checkpoints" / "latest"):
        assert ckpt.normalize_resume_dir(str(spelling)) == str(exp)
    numeric = tmp_path / "17"  # an experiment dir named by a number stays itself
    assert ckpt.normalize_resume_dir(str(numeric)) == str(numeric)
    assert ckpt.resume_scan(str(exp)) == (None, 12)
    (exp / "config.json").write_text("{}")
    assert ckpt.resume_scan(str(exp)) == (str(exp / "config.json"), 12)
    assert ckpt.clear_stale_steps(str(exp)) == 3
    assert ckpt.latest_checkpoint_step(str(exp)) is None
