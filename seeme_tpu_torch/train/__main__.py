"""Training CLI (`train.py`) for the ego, text-to-motion and
action-to-motion configs.

    python -m seeme_tpu_torch.train --preset NAME
        [--batch_size N] [--epochs N] [--out DIR] [--resume DIR]
        [--pretrained_vae PATH] [--nodebug] [--device cpu] [model.FIELD=VALUE ...]
        [train.FIELD=VALUE ...]
    python -m seeme_tpu_torch.train --cfg configs/config_NAME.yaml [--cfg_assets FILE]
        [the same options] [KEY.PATH=VALUE ...]

With `--cfg` the shipped YAML goes through the port's loader and builder
(`config/loader.py`, `config/build.py`: base.yaml, the file, the module
YAMLs, the assets, then the dotted overrides, read as YAML values, as
`train.py` takes them); each YAML builds the same preset as its name below.
The config's DEBUG (true in base.yaml, false in every shipped top-level
YAML) gives the datamodule its small splits; `--nodebug` turns it off, as
`train.py:78-79` does.

NAME is a preset of `config/egobody.py` (vae_egobody, mld_egobody,
mld_egobody_image, vae_gimo, mld_gimo, vae_interactee, mld_interactee) or
of `config/humanml3d.py` (vae_humanml3d, mld_humanml3d, novae_humanml3d;
`dataset=kit` trains them on KIT) or of `config/a2m.py` (vae_humanact12,
mld_humanact12, vae_uestc, mld_uestc). The flow is `train.py`'s: the
datamodule (the EgoBody, GIMO, HumanML3D, KIT, HumanAct12 or UESTC release
under `./datasets` when it is there, else the synthetic one), the system
(`SeeMeSystem`; `T2MSystem` for a text-to-motion preset, whose width in
features follows the data; `A2MSystem` for an action-to-motion one, whose
classes follow the data too),
stage 2's pretrained VAE, the optimizer, the resume; then stage 2's cache of the
frozen encoders' features (`train.py:185-236`: the PointNet's `scene_feats`
and the ResNet50's `image_feats`, in chunks of max(batch, 8), the tail
padded, the train and val splits, only at guidance <= 1; on by default on
the card), and the epochs with logging, validation every `val_every_steps`
epochs and a checkpoint every `save_checkpoint_epoch` epochs and at the
end. Trailing `model.X=V` / `train.X=V` pairs override preset fields (V a
Python literal), as `train.py`'s dotted overrides do. A text-to-motion
batch without `text_emb` (the releases) has its captions encoded on the
host by the system's text encoder before the step (`train.py:337-367`);
the text-to-motion presets have no feature cache, and `vae_type="no"`
(novae_humanml3d) has no VAE stage. An action-to-motion batch is
(`motion`, `action`, `length`) as the datamodule gives it; its stage 2
trains `denoiser` and `embed_action` over the frozen VAE, with no cache.

It runs on the card unless `--device cpu` is given, and raises when there
is no card. On the card, float32 products and convolutions run in full
float32 (TF32 off). The SMPL body of the ego and action configs is the file
`model.smpl_path` names when it exists (`--cfg`), else the synthetic model
(`synthetic_smpl(6890)`). It writes `config.json`, `train_log.txt` and
`checkpoints/<step>.pt` under `--out` (default `experiments/torch/mld/<preset
name>`); with `--cfg` the default is the YAML's `<FOLDER>/torch/<model_type>/<NAME>`,
and it also writes a timestamped `<stamp>_train.log`, the `config.yaml`
snapshot and the TensorBoard / Weights & Biases scalars where those packages
are installed (`utils/logger.py`, as `train.py:83-87`). Every epoch's line
carries `utils/profiling.py::memory_stats` (`train.py:390-394`).

Data parallelism (`parallel/mesh.py`), as the reference's DDP:

    python -m torch.distributed.run --nproc_per_node N -m seeme_tpu_torch.train --cfg FILE ...

Under torchrun (or in a process group already joined) each rank runs on
`cuda:{LOCAL_RANK % cards}` (NCCL when every rank has a card of its own,
gloo when ranks share one), trains the stage's subtrees under
`DistributedDataParallel` on its contiguous rows of each batch (the batch
must split evenly over the ranks), draws each loss call's noise at the
whole batch's shape and keeps its rows, and fills the whole feature cache
itself. Dropout draws from torch's default generators, seeded with seed +
the rank's data coordinate. Only rank 0 writes the logs, `config.json`,
`config.yaml`, the TensorBoard / W&B scalars and the checkpoints (with
every rank's default generators; a resume must use the same world size);
the others wait at a barrier. Outside torchrun it is one process, as before. `--cfg ...
MESH.MODEL_AXIS=m` lays the world out as a (W / m, m) mesh, as
`train.py:238` does: the m model-axis ranks of one data coordinate take the
same rows, every parameter stays replicated under DDP over the world, and
the result is that of a world of W / m; an m that does not divide the
world (any m > 1 in one process) is refused by name.

Dispatch (`train.py:246-327`): on the card the train split goes to the
device once and each step gathers its batch there (`TRAIN.DEVICE_DATA`,
default on for the card, off for the CPU; `train.device_data=` with
`--preset`), when the datamodule has per-sample arrays (a HumanML3D or KIT
release encodes its captions on the host: no), an image config has its
`image_feats` cached (raw crops are host work), and the split, without the
keys the stage never reads, is at most `TRAIN.DEVICE_DATA_MAX_GB` (4.0);
otherwise the log says why, and the host batches are prefetched as before.
Either way the loss terms are fetched once every `TRAIN.STEPS_PER_DISPATCH`
steps (default 8 on the card, 1 on the CPU). Both routes train the same
batches with the same draws; a checkpoint of one resumes on the other. Under
DDP every rank holds the whole split and gathers its own rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import full_float32, resolve_device
from ..config.egobody import OUT_ROOT
from ..config.loader import save_config
from ..config.presets import PRESETS, build, cli_config
from ..data.batch import eval_batches
from ..models.a2m import A2MSystem
from ..models.t2m import T2MSystem
from ..parallel.mesh import (batch_sharding, join_world, leave_world, model_axis_of,
                             process_rank, replicated, shard_batch)
from ..utils.logger import TensorBoardWriter, WandbLogger, create_experiment_dir, create_logger
from ..utils.profiling import memory_stats
from .checkpoint import (
    clear_stale_steps,
    default_rng_states,
    load_pretrained_vae,
    normalize_resume_dir,
    resolve_latest,
    restore_state,
    resume_scan,
    save_state,
    step_path,
)
from .loop import StageLoss, make_device_data, run_epoch, run_epoch_device, validate
from .state import make_optimizer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.train")
    which = p.add_mutually_exclusive_group(required=True)
    which.add_argument("--preset", choices=sorted(PRESETS),
                       help="a preset of config/egobody.py, config/humanml3d.py or config/a2m.py")
    which.add_argument("--cfg", help="a YAML config, e.g. configs/config_mld_egobody.yaml")
    p.add_argument("--cfg_assets", default=None, help="assets YAML merged last (with --cfg)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None, help="END_EPOCH")
    p.add_argument("--out", default=None, help="experiment dir")
    p.add_argument("--resume", default=None,
                   help="experiment dir to resume from (wins over TRAIN.RESUME)")
    p.add_argument("--pretrained_vae", default=None, help="stage-1 checkpoint for stage 2")
    p.add_argument("--nodebug", action="store_true", help="DEBUG false: the full splits")
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*", default=[],
                   help="with --preset model.FIELD=VALUE or train.FIELD=VALUE; with --cfg "
                        "dotted YAML keys, e.g. TRAIN.BATCH_SIZE=8 model.latent_dim=[2,256]")
    return p.parse_args(argv)


def dispatch_settings(tc, on_card: bool) -> Tuple[bool, int]:
    """(whether the device route is asked for, the steps between two
    fetches) of a `TrainConfig`: `TRAIN.DEVICE_DATA` (default on for the
    card only) and `TRAIN.STEPS_PER_DISPATCH` (default 8 on the card, 1
    elsewhere), as `train.py:252-255, :283-285` default them."""
    k = tc.steps_per_dispatch if tc.steps_per_dispatch is not None else 8 if on_card else 1
    return (tc.device_data if tc.device_data is not None else on_card), max(int(k), 1)


class Trainer:
    """One training run, set up as `train.py` sets it up. `main` calls
    `fill_feature_cache` and then `fit`."""

    def __init__(self, args: argparse.Namespace):
        preset, config = cli_config(args.preset, args.cfg, args.cfg_assets, args.overrides)
        if args.nodebug:
            preset = dataclasses.replace(preset, debug=False)
            if config is not None:
                config["DEBUG"] = False
        tc = preset.train
        if args.batch_size is not None:
            tc = dataclasses.replace(tc, batch_size=args.batch_size)
        if args.epochs is not None:
            tc = dataclasses.replace(tc, end_epoch=args.epochs)
        if args.pretrained_vae is not None:
            tc = dataclasses.replace(tc, pretrained_vae=args.pretrained_vae)
        self.preset = preset = dataclasses.replace(preset, train=tc)
        self.device, self.backend, self.mesh, self.joined = join_world(
            resolve_device(args.device), model_axis_of(config))
        self.rank, self.world = process_rank()
        self.shard = batch_sharding(self.mesh)
        self.is_main = self.rank == 0
        full_float32()
        default_dir = (create_experiment_dir(config) if config is not None
                       else os.path.join(OUT_ROOT, preset.name))
        self.exp_dir = os.path.abspath(args.out or default_dir)
        self._log_path = os.path.join(self.exp_dir, "train_log.txt")
        self.logger = None
        self.tb = self.wb = None
        if self.is_main:
            os.makedirs(self.exp_dir, exist_ok=True)
            if config is not None:
                self.logger = create_logger(self.exp_dir, "train")
                save_config(config, os.path.join(self.exp_dir, "config.yaml"))
                self.tb = TensorBoardWriter(
                    self.exp_dir, enabled=bool(config.select("LOGGER.TENSORBOARD", True)))
                self.wb = WandbLogger(config, self.exp_dir)
        self.stage, self.seed = tc.stage, tc.seed
        self.datamodule, self.system = build(preset, self.device)
        if self.shard[1] > 1:  # each data coordinate's dropout masks its own rows
            torch.manual_seed(self.seed + self.shard[0])
        self.preset = preset = dataclasses.replace(preset, model=self.system.cfg)
        self.is_t2m = isinstance(self.system, T2MSystem)
        self.is_a2m = isinstance(self.system, A2MSystem)
        if self.is_t2m and self.system.diffusion_only and self.stage == "vae":
            raise ValueError("the vae stage is undefined for vae_type 'no' "
                             "(config_novae_*: train the diffusion stage only)")
        if self.datamodule.is_synthetic:
            self.log("dataset release not found -> synthetic datamodule")
        if self.stage == "diffusion" and tc.pretrained_vae and hasattr(self.system, "vae"):
            path = resolve_latest(tc.pretrained_vae)
            if os.path.exists(path):
                n = load_pretrained_vae(path, self.system)
                self.log(f"loaded pretrained VAE ({n} tensors) from {path}")
            else:  # as train.py: warn, and train against the random frozen VAE
                self.log(f"WARNING: pretrained VAE {path} does not exist; stage 2 will "
                         "freeze a randomly initialized VAE")

        n_train = self.datamodule.num_train
        self.batch_size = tc.batch_size
        if 0 < n_train < self.batch_size:  # drop_last would leave no step at all
            self.log(f"batch size {self.batch_size} exceeds the train split ({n_train}); "
                     f"clamped to {n_train}")
            self.batch_size = n_train
        if self.batch_size % self.world:
            raise ValueError(f"batch size {self.batch_size} does not split over "
                             f"{self.world} ranks")
        self.steps_per_epoch = max(n_train // self.batch_size, 1)
        self.optimizer, self.schedule = make_optimizer(
            self.stage, self.system, lr=tc.lr, step_size_epochs=tc.step_size, gamma=tc.gamma,
            steps_per_epoch=self.steps_per_epoch)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)

        self.step = self.start_epoch = 0
        # --resume, else TRAIN.RESUME (train.py:155-178): checked before
        # anything is deleted; resuming in place deletes nothing, a warm start
        # from another dir clears this run's stale steps (rank 0), and every
        # rank restores
        resume = args.resume or tc.resume
        if resume:
            key = "--resume" if args.resume else "TRAIN.RESUME"
            resume = normalize_resume_dir(resume)
            if resume_scan(resume)[1] is None:
                raise FileNotFoundError(
                    f"{key}={resume} has no checkpoint under {resume}/checkpoints: refusing "
                    f"to start (a fresh start would delete this run's checkpoints; unset "
                    f"{key} to train from scratch)")
            if resume != self.exp_dir and self.is_main:
                clear_stale_steps(self.exp_dir)
            self.step, _ = restore_state(resume, self.system, self.optimizer, self.generator,
                                         self.rank, self.world)
            self.start_epoch = self.step // self.steps_per_epoch
            self.log(f"resumed from {resume} @ step {self.step} (epoch {self.start_epoch})")
        elif self.is_main and clear_stale_steps(self.exp_dir):
            self.log(f"cleared checkpoints an earlier run left in {self.exp_dir}")
        if self.is_main:
            with open(os.path.join(self.exp_dir, "config.json"), "w") as f:
                json.dump({"preset": args.preset, "cfg": args.cfg,
                           **dataclasses.asdict(preset)}, f, indent=1)
        # the stage's loss under DDP, which broadcasts rank 0's weights now
        self.model = (replicated(StageLoss(self.system, self.stage), self.device)
                      if self.mesh is not None else None)
        self.barrier()
        self.history: List[Dict] = []
        self.route: Optional[Tuple[str, int]] = None  # ("device" | "host", k), set by `fit`
        self.checkpoints: List[str] = []
        world = (f" world={self.world} backend={self.backend} mesh={self.shard[1]}x"
                 f"{self.world // self.shard[1]}" if self.mesh is not None else "")
        self.log(f"stage={self.stage} device={self.device} batch={self.batch_size} "
                 f"steps/epoch={self.steps_per_epoch}{world} out={self.exp_dir}")

    def barrier(self) -> None:
        """Every rank waits here for the others (rank 0's writes); nothing
        outside a process group."""
        if self.mesh is not None:
            dist.barrier()

    def log(self, msg: str) -> None:
        if not self.is_main:
            return
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        if self.logger is not None:
            self.logger.info(msg)
        else:
            print(line, flush=True)
        with open(self._log_path, "a") as f:
            f.write(line + "\n")

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
            self.wb.finish()
        leave_world(self.joined)

    def fill_feature_cache(self) -> Optional[float]:
        """Stage 2's cache of the frozen encoders' features, once per sample
        of the train and val splits: the PointNet's through the fused
        blocks, the ResNet50's; returns its seconds, or None when the cache
        does not apply."""
        cache = self.preset.train.feature_cache
        if cache is None:
            cache = self.device.type == "cuda"
        system = self.system
        encoders = []
        if getattr(system, "use_scene", False):
            encoders.append(("scene", "scene_feats", system.scene_features))
        if getattr(system, "use_image", False):
            encoders.append(("image", "image_feats", system.image_features))
        if not (cache and self.stage == "diffusion" and encoders
                and self.preset.model.guidance_scale <= 1.0):
            return None
        t0 = time.perf_counter()
        cs = max(self.batch_size, 8)
        for raw_key, feat_key, encode in encoders:
            t_enc = time.perf_counter()
            for split in ("train", "val"):
                try:
                    raw = self.datamodule.split_array(split, raw_key)
                except (AttributeError, KeyError, FileNotFoundError):
                    continue  # a release's image crops are picked per batch: no cache
                chunks = []
                for i in range(0, len(raw), cs):
                    chunk = raw[i:i + cs]
                    pad = cs - len(chunk)
                    if pad:  # every chunk at one shape, as the JAX trainer's jit needs
                        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                    feats = encode(torch.as_tensor(chunk, device=self.device))
                    chunks.append(feats[: cs - pad].cpu().numpy())
                self.datamodule.attach_split_features(split, feat_key, np.concatenate(chunks))
                self.log(f"precomputed frozen {raw_key} features for {split} "
                         f"({len(raw)} samples)")
            self.log(f"{raw_key} features cached in {time.perf_counter() - t_enc:.3f} s")
        return time.perf_counter() - t0

    def dropped_keys(self) -> set:
        """The ego batch keys the stage never reads (`train.py:266-270`)."""
        if self.is_t2m or self.is_a2m:
            return set()
        drop = {"scene", "image"} if self.stage == "vae" else set()
        if not self.system.use_image:
            drop.add("image")
        return drop

    def device_split(self) -> Tuple[Optional[Dict[str, np.ndarray]], str]:
        """(the train split's arrays the stage reads, "") when the device
        route applies to this datamodule and config, else (None, why not)
        (`train.py:289-310`)."""
        dm = self.datamodule
        if not (hasattr(dm, "split_arrays") and hasattr(dm, "batch_indices")):
            return None, "the datamodule has no per-sample arrays"
        if self.is_t2m and not dm.is_synthetic:
            return None, "the release's captions are encoded on the host (data/humanml.py:132)"
        arrays = dict(dm.split_arrays("train"))
        for k in self.dropped_keys() | {"image_crops", "image"}:
            arrays.pop(k, None)
        if "scene_feats" in arrays:
            arrays.pop("scene", None)
        if not self.is_t2m and not self.is_a2m and self.system.use_image \
                and "image_feats" not in arrays:
            return None, "raw image crops are host work (no image_feats cache)"
        return arrays, ""

    def dispatch(self) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        """(the train split on the device, or None for host batches; the
        steps between two fetches), chosen and logged as `train.py:246-327`
        chooses: called by `fit` once the feature cache is filled."""
        tc = self.preset.train
        wanted, k = dispatch_settings(tc, self.device.type == "cuda")
        if not wanted:
            self.log(f"host batches (TRAIN.DEVICE_DATA off), {k} steps/dispatch")
            return None, k
        arrays, why = self.device_split()
        gb = 0.0 if arrays is None else sum(v.nbytes for v in arrays.values()) / 1e9
        if arrays is not None and gb > tc.device_data_max_gb:
            why = f"{gb:.4g} GB > TRAIN.DEVICE_DATA_MAX_GB={tc.device_data_max_gb:.4g}"
        if why:
            self.log(f"device-resident split skipped: {why}; host batches, {k} steps/dispatch")
            return None, k
        data = make_device_data(arrays, self.device)
        self.log(f"device-resident train split: {gb:.3f} GB on {self.device}, "
                 f"{k} steps/dispatch")
        return data, k

    def train_batches(self, epoch: int):
        """The train split's batches of `epoch`, without the keys the stage
        never reads, captions encoded."""
        if self.is_t2m:
            for b in self.datamodule.batches("train", self.batch_size, seed=self.seed + epoch):
                yield self.system.encode_captions(b)
            return
        if self.is_a2m:
            yield from self.datamodule.batches("train", self.batch_size, seed=self.seed + epoch)
            return
        drop = self.dropped_keys()
        for b in self.datamodule.batches("train", self.batch_size, seed=self.seed + epoch):
            yield {k: v for k, v in b.items() if k not in drop}

    def val_batches(self):
        """`eval_batches` of the val split, captions encoded."""
        for b, n in eval_batches(self.datamodule, "val", self.batch_size):
            yield (self.system.encode_captions(b) if self.is_t2m else b), n

    def fit(self) -> List[Dict]:
        tc = self.preset.train
        val_every = max(tc.val_every_steps, 1)
        log_every = max(tc.log_every_steps, 1)  # LOGGER.LOG_EVERY_STEPS, in epochs
        data, k = self.dispatch()
        self.route = ("host" if data is None else "device", k)
        common = dict(generator=self.generator, model=self.model, shard=self.shard,
                      steps_per_dispatch=k)
        for epoch in range(self.start_epoch, tc.end_epoch):
            if data is not None:
                self.step, means, steps, ms = run_epoch_device(
                    self.system, self.stage, self.optimizer, self.schedule, self.step, data,
                    self.datamodule.batch_indices("train", self.batch_size, seed=self.seed + epoch),
                    **common)
            else:
                self.step, means, steps, ms = run_epoch(
                    self.system, self.stage, self.optimizer, self.schedule, self.step,
                    (shard_batch(self.mesh, b) for b in self.train_batches(epoch)), **common)
            memory = memory_stats(self.device)
            record = {"epoch": epoch, "means": means, "steps": steps, "step_ms": ms,
                      "memory": memory}
            if epoch % log_every == 0:
                mem = "".join(f" {k}={v:.2f}" for k, v in memory.items())
                if self.device.type == "cuda":
                    mem += f" max_memory_allocated={torch.cuda.max_memory_allocated(self.device)}"
                self.log(f"epoch {epoch}/{tc.end_epoch} step {self.step} "
                         + " ".join(f"{k}={v:.5f}" for k, v in sorted(means.items())) + mem)
                if self.tb is not None:
                    self.tb.scalars(self.step, means, prefix=f"{self.stage}/")
                    self.wb.log(self.step, means, prefix=f"{self.stage}/")
            if (epoch + 1) % val_every == 0:
                record["val"] = validate(self.system, self.stage, (
                    (shard_batch(self.mesh, b), n) for b, n in self.val_batches()), self.shard)
                self.log(f"val epoch {epoch} " + " ".join(
                    f"{k}={v:.5f}" for k, v in sorted(record["val"].items())))
            if (epoch + 1) % tc.save_checkpoint_epoch == 0 or epoch + 1 == tc.end_epoch:
                self.checkpoints.append(self.save(epoch + 1))
                self.log(f"checkpoint @ step {self.step}: {self.checkpoints[-1]}")
            self.history.append(record)
        return self.history

    def save(self, epoch: int) -> str:
        """Rank 0 writes the checkpoint, with every rank's default generators
        in a data-parallel run; the others wait for it."""
        ranks = None
        if self.mesh is not None:
            ranks = [None] * self.world
            dist.all_gather_object(ranks, default_rng_states())
        path = step_path(self.exp_dir, self.step)
        if self.is_main:
            path = save_state(self.exp_dir, self.system, self.optimizer, self.step, epoch,
                              self.generator, ranks)
        self.barrier()
        return path


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    trainer = Trainer(parse_args(argv))
    seconds = trainer.fill_feature_cache()
    if seconds is not None:
        trainer.log(f"feature cache filled in {seconds:.3f} s")
    trainer.fit()
    trainer.close()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
