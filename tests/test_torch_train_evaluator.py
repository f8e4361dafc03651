"""The evaluator trainer (`python -m seeme_tpu_torch.tools.train_evaluator`)
on the CPU.

Each objective on one batch against the same formula on the JAX package's
modules, the weights going from the port through `tools/convert_checkpoint.py`
and the gradients back through the same converters: the TM2T trio's
contrastive hinge (tiny widths), the HumanAct12 GRU's cross-entropy on FK
joints (the JAX FK on the same body) and the UESTC ST-GCN's on the rot6d
block, loss and every gradient within 1e-5 relative (of the loss; of each
tensor's max |g|). Then, for each kind, the file `save` writes loads in the
test CLI's loaders and gives the trainer's outputs bit for bit; and
two-epoch `--debug` runs of the trio and the GRU end, and the test CLI
evaluates with their files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seeme_tpu.core.rotation2xyz import rot6d_motion_to_joints as j_fk
from seeme_tpu.core.smpl import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.eval.action_classifier import MotionDiscriminator as JGru
from seeme_tpu.eval.stgcn import STGCN as JSTGCN
from seeme_tpu.nn import gru as jgru
from seeme_tpu_torch.eval.t2m_evaluator import T2MEvaluator
from seeme_tpu_torch.nn.init import perturb_parameters_
from seeme_tpu_torch.test.__main__ import action_evaluator
from seeme_tpu_torch.test.__main__ import main as eval_cli
from seeme_tpu_torch.tools import train_evaluator as te
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)
from tools.convert_checkpoint import (
    convert_a2m_gru,
    convert_t2m_motionencoder,
    convert_t2m_movementencoder,
    convert_t2m_textencoder,
    convert_uestc_stgcn,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
RTOL = 1e-5
WIDTHS = dict(word_size=300, pos_size=15, text_hidden=16, move_hidden=12, move_out=8,
              motion_hidden=10, output_size=6)
TINY_T2M = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
            "model.text_encoded_dim=48", "model.max_len=24", "model.min_len=8",
            "model.num_inference_timesteps=2"]
TINY_A2M = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
            "model.num_frames=16", "model.num_inference_timesteps=2"]


def trainer(cfg, out, *extra):
    return te.EvaluatorTrainer(te.parse_args(["--cfg", os.path.join(CONFIGS, cfg), "--debug",
                                              "--cpu", "--out", str(out), *extra]))


def numpy_tree(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def port_grads(module, loss=None):
    """{key: gradient} of `module` after `loss.backward()` (when given)."""
    if loss is not None:
        module.zero_grad(set_to_none=True)
        loss.backward()
    return {k: p.grad.numpy() for k, p in module.named_parameters()}


def check(got_loss, want_loss, got_grads, want_grads):
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=RTOL)
    flat_got = jax.tree_util.tree_leaves_with_path(got_grads)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=RTOL * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


def test_contrastive_objective_matches_jax(tmp_path):
    tr = trainer("config_mld_humanml3d.yaml", tmp_path / "t2m.tar")
    tiny = T2MEvaluator(nfeats=tr.dm.nfeats, device="cpu", seed=3, **WIDTHS)
    perturb_parameters_(tiny, torch.Generator().manual_seed(4))
    tr.module = tiny.requires_grad_(True)
    tr.train_mode(True)
    batch = next(tr.dm.batches("train", 6, shuffle=False))
    x = tr.inputs(batch)
    loss = tr.loss(x)
    loss.backward()
    grads = {"text": convert_t2m_textencoder(port_grads(tiny.text_encoder)),
             "move": convert_t2m_movementencoder(port_grads(tiny.movement_encoder)),
             "motion": convert_t2m_motionencoder(port_grads(tiny.motion_encoder))}
    params = {"text": convert_t2m_textencoder(numpy_tree(tiny.text_encoder.state_dict())),
              "move": convert_t2m_movementencoder(numpy_tree(tiny.movement_encoder.state_dict())),
              "motion": convert_t2m_motionencoder(numpy_tree(tiny.motion_encoder.state_dict()))}
    text = jgru.TextEncoderBiGRUCo(word_size=300, pos_size=15, hidden_size=16, output_size=6)
    move = jgru.MovementConvEncoder(hidden_size=12, output_size=8)
    motion = jgru.MotionEncoderBiGRUCo(input_size=8, hidden_size=10, output_size=6)
    arrays = {k: v.numpy() for k, v in x.items()}

    def loss_fn(p):  # the root tool's `loss_fn` (`tools/train_evaluator.py:109-122`)
        emb_t = text.apply(p["text"], arrays["words"], arrays["pos"], arrays["cap_lens"])
        mov = move.apply(p["move"], arrays["feats"][..., :-4])
        emb_m = motion.apply(p["motion"], mov, arrays["length"] // 4)

        def dist(a, b):
            return jnp.sqrt(jnp.sum((a - b) ** 2, -1) + 1e-8)

        hinge = (jax.nn.relu(10.0 - dist(emb_t, jnp.roll(emb_m, 1, axis=0))) ** 2
                 + jax.nn.relu(10.0 - dist(emb_m, jnp.roll(emb_t, 1, axis=0))) ** 2)
        return jnp.mean(dist(emb_t, emb_m) ** 2) + 0.5 * jnp.mean(hinge)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    check(loss, want_loss, grads, want_grads)


@pytest.mark.parametrize("cfg", ["config_mld_humanact12.yaml", "config_mld_uestc.yaml"])
def test_cross_entropy_objective_matches_jax(cfg, tmp_path):
    """The GRU in float32 from the FK of each package; the ST-GCN's ten
    blocks of batch-normed convolutions in float64 on both sides (in float32
    the two summation orders part by 1e-3 of the deepest gradients)."""
    tr = trainer(cfg, tmp_path / "clf.tar")
    perturb_parameters_(tr.module, torch.Generator().manual_seed(6))
    b = next(tr.dm.batches("train", 3, shuffle=False))
    b["motion"] = b["motion"][:, :16]
    b["length"] = np.array([16, 11, 7], np.int32)
    x = tr.inputs(b)
    if tr.kind == "gru":
        params = convert_a2m_gru(numpy_tree(tr.module.state_dict()))
        joints = j_fk(j_synthetic_smpl(n_verts=6890), jnp.asarray(b["motion"]))
        inputs, clf = joints.reshape(3, 16, 72), JGru(output_size=12)
        convert, x64 = convert_a2m_gru, False
    else:
        tr.module.double()
        x["motion"] = x["motion"].double()
        params = convert_uestc_stgcn(numpy_tree(tr.module.state_dict()))
        inputs, clf = x["motion"][..., :144].reshape(3, 16, 24, 6).numpy(), JSTGCN(num_class=40)
        convert, x64 = convert_uestc_stgcn, True
    loss = tr.loss(x)
    grads = convert(port_grads(tr.module, loss))

    def loss_fn(p):  # the root tool's (`tools/train_evaluator.py:252-255`)
        logits, _ = clf.apply(p, inputs, b["length"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, b["action"]).mean()

    with jax.enable_x64(x64):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    check(loss, want_loss, grads, want_grads)


def small_batch(tr):
    b = next(tr.dm.batches("val", 3, shuffle=False))
    b["motion"] = b["motion"][:, :16]
    b["length"] = np.minimum(b["length"], 16)
    return b


def loaded_outputs(tr, path, b):
    """The test CLI loaders' outputs on `b` from the file at `path`."""
    with torch.no_grad():
        if tr.kind == "t2m":
            ev = T2MEvaluator(nfeats=tr.dm.nfeats, ckpt=path, device="cpu")
            assert ev.is_pretrained
            words, pos, lens = (np.stack([r[i] for r in (
                ev.vectorizer.tokens_to_arrays(t.split(), 20) for t in b["text"])])
                for i in range(3))
            emb_t = ev.text_encoder(torch.as_tensor(words), torch.as_tensor(pos),
                                    torch.as_tensor(lens))
            return emb_t, torch.as_tensor(ev.embed_motion(tr.dm.renorm4t2m(b["motion"]),
                                                          b["length"]))
        clf = action_evaluator(tr.name, tr.dm.num_classes, 99, torch.device("cpu"),
                               checkpoint=path)
        return clf(tr.classifier_input(torch.as_tensor(b["motion"])),
                   torch.as_tensor(b["length"]))[0]


@pytest.mark.parametrize("cfg", ["config_mld_humanml3d.yaml", "config_mld_humanact12.yaml",
                                 "config_mld_uestc.yaml"])
def test_written_file_loads_in_the_test_cli_loaders(cfg, tmp_path):
    """After a step, `save` writes what the loaders read: their outputs on a
    fixed batch equal the trainer's bit for bit."""
    tr = trainer(cfg, tmp_path / "e.tar")
    b = small_batch(tr)
    tr.step(tr.inputs(b))
    tr.save(str(tmp_path / "e.tar"))
    tr.freeze()
    with torch.no_grad():
        want = tr.outputs(tr.inputs(b))
    got = loaded_outputs(tr, str(tmp_path / "e.tar"), b)
    for g, w in zip(got, want) if tr.kind == "t2m" else [(got, want)]:
        assert torch.equal(g, w)


@pytest.mark.parametrize("cfg,preset,key,tiny", [
    ("config_mld_humanml3d.yaml", "mld_humanml3d", "evaluator_dir", TINY_T2M),
    ("config_mld_humanact12.yaml", "mld_humanact12", "evaluator_checkpoint", TINY_A2M)])
def test_debug_run_ends_and_the_test_cli_evaluates_with_it(cfg, preset, key, tiny, tmp_path):
    out = str(tmp_path / "evaluator.tar")
    tr = te.main(["--cfg", os.path.join(CONFIGS, cfg), "--debug", "--cpu", "--epochs", "2",
                  "--out", out])
    assert np.isfinite([r["loss"] for r in tr.history]).all() and len(tr.history) == 2
    assert "metric" in tr.history[-1] and 0.0 <= tr.final_metric <= 1.0
    assert len(tr.timer.times) == sum(r["steps"] for r in tr.history) > 0
    result = eval_cli(["--preset", preset, "--device", "cpu", "--out", str(tmp_path / "t"),
                       f"test.{key}={out!r}"] + tiny)
    assert all(np.isfinite(v["mean"]) for v in result["stats"].values())
    assert "loaded evaluator" in open(tmp_path / "t" / "test_log.txt").read()
