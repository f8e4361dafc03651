"""Demo CLI (`demo.py` at the repo root): sample motions from a config and
write them as `.npy` joints.

    python -m seeme_tpu_torch.demo --cfg configs/config_NAME.yaml [--cfg_assets FILE]
        [--checkpoint PATH] [--num_samples 4] [--out demo_out] [--mesh]
        [--example FILE] [--task text_motion|random_sampling|reconstruction]
        [--length N] [--actions 0,3] [--replication 1] [--render]
        [--device cpu | --cpu] [KEY.PATH=VALUE ...]

The flags are the root script's (`demo.py:22-51`), and so is the dispatch
by DATASET_NAME (`:298-322`):

* ego configs (EgoBody, GIMO): the first `--num_samples` rows of the test
  split -> `encode_conditioning` -> `sample_from_cond` (one kernel-3
  launch a batch on the card) -> `eval_fk`; `sample_{i}.npy` and `gt_{i}.npy`
  (T, 24, 3), and with `--mesh` `sample_{i}_mesh.npy` (T, V, 3) from the full
  skinning forward and `faces.npy` (`:227-296`);
* text configs (HumanML3D, KIT): captions from an `--example` file of
  '<length> <caption>' lines (plain caption lines take `--length`, else
  MAX_LEN), else the test split's; `captions.txt` and `sample_{i}.npy`
  (one kernel-5 launch a replication); without `--example`, `--task
  random_sampling` decodes standard-normal latents (`random_{i}.npy`) and
  `--task reconstruction` round-trips test motions through the VAE
  (`rec_{i}.npy`, `gt_{i}.npy`) (`:84-177`);
* action configs (HumanAct12, UESTC): `--actions` class ids (default the
  first `--num_samples` classes) -> `sample` (one kernel-5 launch a
  replication) -> FK; `action_{a}.npy` (`:179-225`).

With `--replication` > 1 the text and action files get a `_{rep}` suffix.
Weights come from `--checkpoint` (else TEST.CHECKPOINTS: a trainer's
`<step>.pt`, its experiment dir or `.../checkpoints/latest`) when it
exists, else the seeded random init (SEED_VALUE); the noise from a
generator seeded with 0. The ego and action configs run on the SMPL file
`model.smpl_path` names when it exists (`demo.py:206`), else on the
synthetic body. Joints are written as float32, as the JAX CLI
writes them. `--render` draws each written joint file to a `.gif` beside it
on the host (`render/joints.py`, matplotlib): an ego sample over its ground
truth (`sample_{i}.gif`, `demo.py:285-293`), a text or action sample alone
(`demo.py:72-81`, `:321-322`); without matplotlib it raises an ImportError
naming it, after the `.npy` files are written. It runs on the card unless
`--device cpu` (or `--cpu`) is given, and raises when there is no card.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ._device import full_float32, resolve_device
from .config.build import A2M_DATASETS, T2M_DATASETS, build_system
from .config.loader import load_config, parse_dotted_overrides
from .data.batch import eval_batches
from .data.synthetic import to_torch
from .models.seeme import INTERACTEE, WEARER
from .train.checkpoint import load_weights, resolve_latest


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.demo")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--cfg_assets", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num_samples", type=int, default=4)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--render", action="store_true",
                    help="render the written joints to gifs (needs matplotlib)")
    ap.add_argument("--mesh", action="store_true",
                    help="(ego) also write sample_{i}_mesh.npy SMPL vertex sequences")
    ap.add_argument("--example", default=None,
                    help="text file, one '<length> <caption>' per line")
    ap.add_argument("--task", default=None,
                    choices=["text_motion", "random_sampling", "reconstruction"],
                    help="text-config mode when no --example is given")
    ap.add_argument("--length", type=int, default=None,
                    help="motion length for caption lines without one")
    ap.add_argument("--actions", default=None,
                    help="comma-separated class ids for action configs")
    ap.add_argument("--replication", type=int, default=1,
                    help="samples per caption or action")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("overrides", nargs="*", default=[], help="dotted YAML keys, KEY.PATH=VALUE")
    return ap.parse_args(argv)


def load_example_input(txt_path: str, default_len: int):
    """'<length> <caption...>' per line (`mld/utils/demo_utils.py:6-20`);
    a plain caption line takes `default_len`."""
    texts, lens = [], []
    with open(txt_path) as f:
        for raw in f:
            s = raw.strip()
            if not s:
                continue
            head = s.split(" ")[0]
            try:
                lens.append(int(head))
                texts.append(s[len(head) + 1:])
            except ValueError:
                lens.append(default_len)
                texts.append(s)
    return texts, lens


def _save(path: str, joints, saved: List[str]) -> None:
    np.save(path, np.asarray(joints, dtype=np.float32))
    saved.append(path)


def _demo_text(args, dm, system, dev, gen) -> List[str]:
    """Text-to-motion: captions, random latents or reconstruction."""
    scfg = system.cfg
    default_len = args.length or scfg.max_len  # DATASET.SAMPLER.MAX_LEN
    task = args.task or "text_motion"
    saved: List[str] = []
    if task == "reconstruction" and args.example is None:
        batch_np, n_valid = next(eval_batches(dm, "test", args.num_samples))
        batch_np.pop("text", None)
        batch = to_torch(batch_np, dev)
        joints = system.feats_to_joints(system.reconstruct(batch, generator=gen)).cpu().numpy()
        joints_gt = system.feats_to_joints(batch["motion"]).cpu().numpy()
        for i in range(min(args.num_samples, n_valid)):  # the padded tail repeats a row
            L = int(batch_np["length"][i])
            for name, arr in (("rec", joints[i, :L]), ("gt", joints_gt[i, :L])):
                _save(os.path.join(args.out, f"{name}_{i}.npy"), arr, saved)
        return saved
    if task == "random_sampling" and args.example is None:
        z = torch.randn((args.num_samples, *scfg.latent_dim), generator=gen, device=dev)
        lengths = torch.full((args.num_samples,), default_len, device=dev)
        with torch.no_grad():
            feats = system.vae.decode(z, scfg.max_len, lengths)
        joints = system.feats_to_joints(feats).cpu().numpy()
        for i in range(args.num_samples):
            _save(os.path.join(args.out, f"random_{i}.npy"), joints[i, :default_len], saved)
        return saved
    if args.example:
        texts, lens = load_example_input(args.example, default_len)
    else:
        batch_np, n_valid = next(eval_batches(dm, "test", args.num_samples))
        n_take = min(args.num_samples, n_valid)
        texts = list(batch_np.get("text", []))[:n_take]
        lens = [int(x) for x in batch_np["length"][:n_take]]
        if not texts:
            raise SystemExit("dataset provides no captions; pass --example captions.txt")
    text_emb = torch.as_tensor(system.text_encoder(texts), device=dev)
    mask = system.text_encoder.token_mask(texts)
    cond_mask = None if mask is None else torch.as_tensor(mask, device=dev)
    lengths = torch.as_tensor(np.array(lens, np.int64), device=dev)
    with open(os.path.join(args.out, "captions.txt"), "w") as f:
        f.writelines(f"{L} {t}\n" for L, t in zip(lens, texts))
    for rep in range(args.replication):
        feats = system.sample(text_emb, lengths=lengths, cond_mask=cond_mask, generator=gen)
        joints = system.feats_to_joints(feats).cpu().numpy()
        suffix = f"_{rep}" if args.replication > 1 else ""
        for i, (L, text) in enumerate(zip(lens, texts)):
            path = os.path.join(args.out, f"sample_{i}{suffix}.npy")
            _save(path, joints[i, :L], saved)
            print(f"[{i}] len={L} {text!r} -> {path}")
    return saved


def _demo_action(args, system, dev, gen) -> List[str]:
    """Action-to-motion: class-conditional sampling, then FK."""
    if args.actions:
        action_ids = [int(x) for x in args.actions.split(",")]
    else:
        action_ids = list(range(min(args.num_samples, system.cfg.num_classes)))
    labels = torch.as_tensor(action_ids, device=dev)
    saved: List[str] = []
    for rep in range(args.replication):
        joints = system.feats_to_joints(system.sample(labels, generator=gen)).cpu().numpy()
        suffix = f"_{rep}" if args.replication > 1 else ""
        for i, a in enumerate(action_ids):
            path = os.path.join(args.out, f"action_{a}{suffix}.npy")
            _save(path, joints[i], saved)
            print(f"action {a} ({a}) -> {path}")
    return saved


def _demo_ego(args, dm, system, dev, gen) -> List[str]:
    """Ego: the wearer (or interactee) sampled from test-split conditions."""
    scfg = system.cfg
    batch_np, n_valid = next(eval_batches(dm, "test", args.num_samples))
    n_take = min(args.num_samples, n_valid)  # the padded tail repeats a row
    batch = to_torch(batch_np, dev)
    feats = system.sample_from_cond(system.encode_conditioning(batch), generator=gen)
    out = system.eval_fk(batch, feats)
    joints, joints_gt = out["joints_rst"].cpu().numpy(), out["joints_ref"].cpu().numpy()
    saved: List[str] = []
    for i in range(n_take):
        _save(os.path.join(args.out, f"sample_{i}.npy"), joints[i], saved)
        np.save(os.path.join(args.out, f"gt_{i}.npy"), joints_gt[i].astype(np.float32))
    print(f"saved {n_take} samples to {args.out}/")
    if args.mesh:
        actor = WEARER if scfg.estimate == "wearer" else INTERACTEE
        betas = batch["betas"][:, actor]
        transl = None if scfg.predict_transl else batch["transl"][:, actor]
        with torch.no_grad():
            verts = system.feats_to_vertices(system.renorm(feats), betas, transl).cpu().numpy()
        for i in range(n_take):
            np.save(os.path.join(args.out, f"sample_{i}_mesh.npy"), verts[i].astype(np.float32))
        np.save(os.path.join(args.out, "faces.npy"), system.smpl.faces)
        print(f"saved {n_take} mesh npys (+faces.npy)")
    if args.render:
        from .render.joints import render_joints_video

        for i in range(n_take):
            path = render_joints_video(joints[i], os.path.join(args.out, f"sample_{i}.gif"),
                                       gt_joints=joints_gt[i], title=f"sample {i}")
            print(f"rendered {path}")
    return saved


def _render_all(paths: Sequence[str]) -> None:
    """Each joint file -> a `.gif` beside it (`demo.py:72-81`)."""
    from .render.joints import render_joints_video

    for p in paths:
        gif = render_joints_video(np.load(p), p.replace(".npy", ".gif"),
                                  title=os.path.basename(p)[:-4])
        print(f"rendered {gif}")


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the demo; returns the `.npy` joint files written."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    full_float32()
    cfg = load_config(args.cfg, args.cfg_assets,
                      overrides=parse_dotted_overrides(args.overrides))
    preset, dm, system = build_system(cfg, dev)
    ckpt = args.checkpoint or preset.test.checkpoint
    ckpt = resolve_latest(ckpt) if ckpt else ckpt
    if ckpt and os.path.exists(ckpt):
        print(f"loaded {load_weights(ckpt, system)}")
    else:
        print("no checkpoint — sampling from random init")
    os.makedirs(args.out, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    if preset.dataset in T2M_DATASETS:
        saved = _demo_text(args, dm, system, dev, gen)
    elif preset.dataset in A2M_DATASETS:
        saved = _demo_action(args, system, dev, gen)
    else:
        return _demo_ego(args, dm, system, dev, gen)
    if args.render:
        _render_all(saved)
    return saved


if __name__ == "__main__":
    main(sys.argv[1:])
