"""Train the evaluators behind the action- and text-to-motion metrics
(`tools/train_evaluator.py`).

    python -m seeme_tpu_torch.tools.train_evaluator --cfg configs/config_NAME.yaml
        [--cfg_assets FILE] [--epochs 50] [--batch_size 32] [--lr 2e-4] --out PATH
        [--seed 0] [--debug] [--device cpu | --cpu]

The reference scores generated motion with pretrained recognition and
retrieval models whose training code it does not ship. This trains the same
architectures on the datamodule's train split (the release under
`./datasets` when it is there, the synthetic splits otherwise), so that the
test CLI's metrics compare with something:

- HumanAct12 (`:169-294` of the root tool): the GRU `MotionDiscriminator` on
  FK joints (`core/rotation2xyz.py` on the configured SMPL body); UESTC: the
  `STGCN` on the rot6d block. Cross-entropy, Adam, accuracy on `eval_batches`
  of the val split (UESTC: the test split) every 5 epochs and at the end.
  `--out` is a torch file of the model's state dict under the reference's
  keys, which `test.evaluator_checkpoint=` (TEST.EVALUATOR_CHECKPOINT) loads.
- HumanML3D / KIT (`:56-166`): the TM2T trio (`TextEncoderBiGRUCo`,
  `MovementConvEncoder` over `feats[..., :-4]`, `MotionEncoderBiGRUCo` over
  `lengths // unit_len`) with the contrastive hinge of T2M's text-motion
  matching: mean(d_pos^2) + 0.5 mean(relu(10 - d_neg_tm)^2 + relu(10 -
  d_neg_mt)^2), the negatives rolled by one row in the batch, d = sqrt(sum
  (a - b)^2 + 1e-8); R@1 in pools of 32 on the val split every 5 epochs and
  on the test split at the end. `--out` is a torch file with the
  `text_encoder` / `movement_encoder` / `motion_encoder` state dicts, which
  `test.evaluator_dir=` (TEST.T2M_EVALUATOR_DIR) loads.

`--debug` sets DEBUG (the small synthetic splits) and clips of 16-64 frames.
Weights start from the seeded init of the test CLI's loaders (`--seed`);
the MovementConvEncoder's dropout stays off, as the JAX trio has none. It
runs on the card unless `--device cpu` (or `--cpu`) is given, and raises
when there is no card.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._device import full_float32, resolve_device
from ..config.build import A2M_DATASETS, T2M_DATASETS, load_smpl_or_synthetic, preset_from_yaml
from ..config.loader import load_config
from ..core.rotation2xyz import POSE_FEATS, rot6d_motion_to_joints
from ..core.smpl import NUM_JOINTS
from ..data.batch import eval_batches
from ..data.registry import get_datamodule
from ..eval.stgcn import STGCN
from ..eval.t2m_evaluator import T2MEvaluator
from ..test.__main__ import action_evaluator
from ..utils.profiling import StepTimer

MARGIN = 10.0   # the hinge's margin on negative pairs
POOL = 32       # R-precision's candidate pool


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.train_evaluator")
    p.add_argument("--cfg", required=True)
    p.add_argument("--cfg_assets", default=None)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--out", required=True, help="the evaluator's torch file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true",
                   help="small synthetic split (DEBUG) and 16-64 frame clips")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return p.parse_args(argv)


def _logger() -> logging.Logger:
    logger = logging.getLogger("seeme_tpu_torch.train_evaluator")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(h)
        logger.propagate = False
    return logger


def contrastive_loss(emb_t: torch.Tensor, emb_m: torch.Tensor) -> torch.Tensor:
    """The text-motion matching objective on (B, D) caption and motion embeddings."""
    def dist(a, b):
        return torch.sqrt(((a - b) ** 2).sum(-1) + 1e-8)

    pos = dist(emb_t, emb_m)
    neg_tm = dist(emb_t, torch.roll(emb_m, 1, dims=0))
    neg_mt = dist(emb_m, torch.roll(emb_t, 1, dims=0))
    hinge = F.relu(MARGIN - neg_tm) ** 2 + F.relu(MARGIN - neg_mt) ** 2
    return (pos ** 2).mean() + 0.5 * hinge.mean()


class EvaluatorTrainer:
    """One evaluator's training run; `fit` trains, `save` writes `--out`."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.device = dev = resolve_device("cpu" if args.cpu else args.device)
        full_float32()
        self.log = _logger()
        overrides = ({"DEBUG": True, "DATASET": {"SAMPLER": {"MAX_LEN": 64, "MIN_LEN": 16}}}
                     if args.debug else None)
        cfg = load_config(args.cfg, args.cfg_assets, overrides=overrides)
        preset = preset_from_yaml(cfg)
        name = preset.dataset
        if name in T2M_DATASETS:
            mc = preset.model
            self.dm = get_datamodule(name, motion_length=mc.max_len, min_len=mc.min_len,
                                     text_dim=mc.text_encoded_dim, debug=args.debug)
            self.kind = "t2m"
            ev = T2MEvaluator(nfeats=self.dm.nfeats,
                              glove_root=preset.test.word_vectorizer_path or None,
                              device=dev, seed=args.seed)
            self.vectorizer, self.max_text_len, self.unit_len = (
                ev.vectorizer, ev.max_text_len, ev.unit_len)
            self.module = ev
        elif name in A2M_DATASETS:
            self.dm = get_datamodule(name, motion_length=preset.model.num_frames,
                                     debug=args.debug)
            self.module = action_evaluator(name, self.dm.num_classes, args.seed, dev,
                                           hidden=preset.test.evaluator_hidden,
                                           layers=preset.test.evaluator_layers)
            self.kind = "stgcn" if isinstance(self.module, STGCN) else "gru"
            self.smpl = load_smpl_or_synthetic(cfg).to(dev)
        else:
            raise SystemExit(f"evaluator training covers the a2m / t2m datasets, got {name}")
        self.name = name
        self.module.requires_grad_(True)
        self.train_mode(True)
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=args.lr)
        self.timer = StepTimer(args.batch_size, print_every=10 ** 9, device=dev)
        self.history: List[Dict] = []

    def train_mode(self, on: bool) -> None:
        """Recurrent layers train (cuDNN's backward needs it; they have no
        dropout), dropout never does."""
        self.module.train(on)
        for m in self.module.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()

    def freeze(self) -> None:
        """Frozen and in eval mode, as the test CLI's loaders leave the model:
        its outputs are then the loaded file's bit for bit (on the CPU,
        oneDNN picks other convolution kernels for weights that require grad)."""
        self.train_mode(False)
        self.module.requires_grad_(False)

    # ---- inputs and objectives
    def inputs(self, b: Dict) -> Dict[str, torch.Tensor]:
        """A host batch as the model's tensors on the device."""
        dev = self.device
        if self.kind == "t2m":
            rows = [self.vectorizer.tokens_to_arrays(t.split(), self.max_text_len)
                    for t in b["text"]]
            words, pos, lens = (np.stack([r[i] for r in rows]) for i in range(3))
            feats = self.dm.renorm4t2m(np.asarray(b["motion"], np.float32))
            return {"words": torch.as_tensor(words, device=dev),
                    "pos": torch.as_tensor(pos, device=dev),
                    "cap_lens": torch.as_tensor(lens),
                    "feats": torch.as_tensor(np.ascontiguousarray(feats), device=dev),
                    "length": torch.as_tensor(b["length"], device=dev)}
        return {"motion": torch.as_tensor(np.ascontiguousarray(b["motion"]), device=dev),
                "length": torch.as_tensor(b["length"], device=dev),
                "action": torch.as_tensor(b["action"], device=dev).long()}

    def classifier_input(self, motion: torch.Tensor) -> torch.Tensor:
        B, T = motion.shape[:2]
        if self.kind == "stgcn":  # the rot6d pose block
            return motion[..., :POSE_FEATS].reshape(B, T, NUM_JOINTS, 6)
        return rot6d_motion_to_joints(self.smpl, motion).reshape(B, T, NUM_JOINTS * 3)

    def outputs(self, x: Dict[str, torch.Tensor]):
        """(caption, motion) embeddings of the trio, or the classifier's logits."""
        m = self.module
        if self.kind == "t2m":
            emb_t = m.text_encoder(x["words"], x["pos"], x["cap_lens"])
            mov = m.movement_encoder(x["feats"][..., :-4])
            return emb_t, m.motion_encoder(mov, x["length"] // self.unit_len)
        return m(self.classifier_input(x["motion"]), x["length"])[0]

    def loss(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.kind == "t2m":
            return contrastive_loss(*self.outputs(x))
        return F.cross_entropy(self.outputs(x), x["action"])

    def step(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One Adam update; returns the loss (on the device)."""
        with self.timer:
            loss = self.loss(x)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        return loss.detach()

    def train_batches(self, epoch: int):
        for b in self.dm.batches("train", self.args.batch_size, seed=self.args.seed + epoch):
            if self.kind != "t2m" or b.get("text") is not None:
                yield b

    # ---- metrics
    @torch.no_grad()
    def metric(self, split: str) -> float:
        """Accuracy over the split's `eval_batches`, or R@1 in pools of 32."""
        hit = tot = 0
        if self.kind == "t2m":
            for b in self.dm.batches(split, POOL, shuffle=False):
                texts = b.get("text")
                if texts is None or len(texts) < POOL:
                    continue
                emb_t, emb_m = (e.cpu().numpy() for e in self.outputs(self.inputs(b)))
                d = np.linalg.norm(emb_t[:, None] - emb_m[None], axis=-1)
                hit += int((np.argmin(d, axis=1) == np.arange(len(d))).sum())
                tot += len(d)
            return hit / max(tot, 1)
        for b, nv in eval_batches(self.dm, split, self.args.batch_size):
            x = self.inputs(b)
            match = (self.outputs(x).argmax(-1) == x["action"]).cpu().numpy()
            hit += int(match[:nv].sum())
            tot += nv
        return hit / max(tot, 1)

    @property
    def metric_name(self) -> str:
        return "val R@1(32)" if self.kind == "t2m" else "val_acc"

    @property
    def metric_split(self) -> str:
        return "test" if self.name == "uestc" else "val"

    def fit(self) -> List[Dict]:
        epochs = self.args.epochs
        loss_name = "contrastive" if self.kind == "t2m" else "ce"
        for epoch in range(epochs):
            losses = [self.step(self.inputs(b)) for b in self.train_batches(epoch)]
            mean = float(torch.stack(losses).mean()) if losses else float("nan")
            record = {"epoch": epoch, "loss": mean, "steps": len(losses)}
            if epoch % 5 == 0 or epoch == epochs - 1:
                record["metric"] = self.metric(self.metric_split)
                self.log.info("epoch %d/%d %s=%.4f %s=%.3f", epoch, epochs, loss_name, mean,
                              self.metric_name, record["metric"])
            self.history.append(record)
        return self.history

    def state(self) -> Dict:
        """The checkpoint the test CLI's loaders read."""
        m = self.module
        if self.kind == "t2m":
            return {part: {k: v.detach().cpu() for k, v in getattr(m, part).state_dict().items()}
                    for part in ("text_encoder", "movement_encoder", "motion_encoder")}
        return {k: v.detach().cpu() for k, v in m.state_dict().items()}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(self.state(), path)


def main(argv: Optional[Sequence[str]] = None) -> EvaluatorTrainer:
    """Train, freeze, score (`final_metric`: the trio's test R@1(32), the
    classifier's accuracy on its metric split) and write `--out`."""
    trainer = EvaluatorTrainer(parse_args(argv))
    trainer.fit()
    trainer.freeze()
    split = "test" if trainer.kind == "t2m" else trainer.metric_split
    trainer.final_metric = trainer.metric(split)
    trainer.save(trainer.args.out)
    what = "R@1(32)" if trainer.kind == "t2m" else "accuracy"
    ms = [1e3 * t for t in trainer.timer.times]
    trainer.log.info("saved %s evaluator to %s (final %s %s=%.3f; %d steps, median %.3f ms a "
                     "step)", trainer.kind, trainer.args.out, split, what, trainer.final_metric,
                     len(ms), float(np.median(ms)) if ms else float("nan"))
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
