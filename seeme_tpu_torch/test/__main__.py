"""Evaluation CLI: the EgoBody/GIMO branch of `test.py` (`test.py:80-205`),
its text-to-motion branch (`_t2m_eval`, `test.py:222-364`) and its
action-to-motion branch (`_a2m_eval`, `test.py:365-450`).

    python -m seeme_tpu_torch.test --preset NAME [--batch_size N]
        [--replication_times N] [--checkpoint PATH] [--count_time]
        [--save_predictions] [--device cpu] [--out DIR] [--trace DIR]
        [model.FIELD=VALUE ...] [test.FIELD=VALUE ...]
    python -m seeme_tpu_torch.test --cfg configs/config_NAME.yaml [--cfg_assets FILE]
        [the same options] [KEY.PATH=VALUE ...]

`--cfg` reads a shipped YAML with dotted YAML overrides (`TEST.MM=true`,
`model.latent_dim=[2,256]`), as `test.py` does (`config/presets.py::cli_config`).

NAME is a preset of `config/egobody.py`, `config/humanml3d.py` or
`config/a2m.py`. The system is built from it and,
with a checkpoint (`--checkpoint`, else the preset's `test.checkpoint`: a
trainer's `<step>.pt`, its experiment dir or `.../checkpoints/latest`),
loaded; without one it evaluates the seeded random init, as `test.py`
does. A checkpoint that is named but missing is an error.

The test split is evaluated `replication_times` times; replication `r`
draws its noise from a generator seeded with SEED_VALUE + r. A stage-`vae`
preset reconstructs through the VAE (`reconstruct`, with TEST.MEAN and
TEST.FACT); a stage-2 preset runs `encode_conditioning` once per batch and
reuses the tokens in every replication (they do not depend on the noise;
with `--count_time` every batch encodes again, so each timed window holds
the whole sampling path), then `sample_from_cond`. Then `eval_fk`, and the
`EgoMetric` over the batch's `n_valid` rows (the padded tail does not
count). It writes `metrics_<stamp>.json` (mean, 1.96 sigma / sqrt(n)
confidence interval, min, max of each metric over the replications),
`test_log.txt`, with `--count_time` `times.txt` (each batch's seconds), and
with `--save_predictions` one `pred_<i>.npy` / `gt_<i>.npy` of joints per
sequence of the first replication, under `--out` (default
`experiments/torch/mld/<preset name>`; with `--cfg` the YAML's
`<FOLDER>/torch/<model_type>/<NAME>`, where it also writes a timestamped
`<stamp>_test.log`, as `test.py:63-64`). The ego and action configs' SMPL
body is the file `model.smpl_path` names when it exists (`--cfg`), else
the synthetic one.

A text-to-motion preset evaluates the test split the same number of
times: each batch's captions are encoded on the host when it carries no
`text_emb`; a stage-`vae` preset reconstructs through the VAE, the others
`sample` the text (with the token mask in the token modes; the pooled VAE
model through the token DDIM kernel, once a batch); joints by RIC recovery
and `MRMetrics` over the `n_valid` rows; `TM2TMetrics` on the TM2T
evaluator's embeddings of the captions and of the sampled and reference
features in the evaluator's normalization (`renorm4t2m`). The evaluator
runs its seeded random init unless `test.evaluator_dir` names the released
weights. With `test.mm=True` it then samples the first
`test.mm_num_samples` test captions `test.mm_num_repeats` times (noise from
a generator seeded with 7) and adds `MMMetrics`' MultiModality over the
flattened features to every replication.

An action-to-motion preset samples each test batch's labels (one
kernel-5 launch a batch and replication on the card), classifies the
sampled and the real motions with the recognition model of its dataset
(HumanAct12: the GRU `MotionDiscriminator` on FK joints; UESTC: the
`STGCN` on the rot6d block) and scores `ActionMetrics` (FID, accuracy,
Diversity, MultiModality) over the `n_valid` rows. The evaluator runs its
seeded random init unless `test.evaluator_checkpoint` names weights under
the reference's keys (TEST.EVALUATOR_HIDDEN / EVALUATOR_LAYERS size the
GRU, `test.py:397-401`).

TEST.USE_FUSED (`test.py:73-87`) sets every branch's `use_fused`: true
samples through the fused DDIM kernel where the model takes it, false
through the `ddim_sample` loop. The one difference from `test.py`: with the
key absent the port keeps the model's own `use_fused` (the kernel, as
shipped), where `test.py` defaults to its scan because its bf16 kernel
drifts about 0.8% (`seeme_tpu/models/seeme.py:70-74`); the port's kernels
are f32 and held to 1e-3 of max|z|. An ego model on the loop at eta > 0
draws its per-step noise from the replication's generator.

`--trace DIR` runs the replications under `utils/profiling.py::device_trace`
and writes `DIR/trace.json` (a Chrome trace) and `DIR/spans.json` (the
program's spans and counters, `profiling.summary()`); each test batch is a
`batch` span keyed by its index in the run, and its layers' spans (`encode`,
`sample`, `joints`, `metric` and their parts) nest under it. Rank 0 traces.

It runs on the card unless `--device cpu` is given, and raises when there
is no card. On the card, float32 products and convolutions run in full
float32 (TF32 off).

Under torchrun (`python -m torch.distributed.run --nproc_per_node N -m
seeme_tpu_torch.test ...`, or in a process group already joined) the ego
branch shards each test batch over the ranks, as `test.py` samples a
batch-sharded batch (`make_eval_sample_step(mesh)`): each rank takes its
contiguous rows, draws its initial noise at the whole batch's shape and
keeps its rows, counts its valid rows, and `EgoMetric.compute(sync=True)`
sums the metric accumulators over the ranks, so every rank's means are the
whole set's. The text- and action-to-motion branches sync no metric in
`test.py`: there every rank evaluates the whole set. Only rank 0 writes
(logs, metrics, times, predictions, gathered from every rank).
`MESH.MODEL_AXIS` is not read, as `test.py` does not read it.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import full_float32, resolve_device
from ..config.egobody import OUT_ROOT
from ..config.presets import PRESETS, build, cli_config
from ..core.masks import lengths_to_mask
from ..core.rotation2xyz import POSE_FEATS
from ..core.smpl import NUM_JOINTS
from ..data.batch import eval_batches
from ..data.synthetic import to_torch
from ..convert import load_reference_checkpoint
from ..eval.action_classifier import MotionDiscriminator
from ..eval.action_metrics import ActionMetrics
from ..eval.metrics import EgoMetric
from ..eval.stgcn import STGCN
from ..eval.stats import get_metric_statistics
from ..eval.t2m_evaluator import T2MEvaluator
from ..eval.t2m_metrics import MMMetrics, MRMetrics, TM2TMetrics
from ..models.a2m import A2MSystem
from ..models.t2m import T2MSystem
from ..nn.init import init_parameters_
from ..parallel.mesh import (batch_sharding, join_world, leave_world, process_rank, rows,
                             shard_batch, valid_rows)
from ..train.checkpoint import load_weights
from ..utils.logger import create_experiment_dir, create_logger
from ..utils.profiling import clear, device_trace, span, summary


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.test")
    which = p.add_mutually_exclusive_group(required=True)
    which.add_argument("--preset", choices=sorted(PRESETS),
                       help="a preset of config/egobody.py, config/humanml3d.py or config/a2m.py")
    which.add_argument("--cfg", help="a YAML config, e.g. configs/config_mld_egobody.yaml")
    p.add_argument("--cfg_assets", default=None, help="assets YAML merged last (with --cfg)")
    p.add_argument("--batch_size", type=int, default=None, help="TEST.BATCH_SIZE")
    p.add_argument("--replication_times", type=int, default=None, help="TEST.REPLICATION_TIMES")
    p.add_argument("--checkpoint", default=None, help="TEST.CHECKPOINTS")
    p.add_argument("--count_time", action="store_true", help="TEST.COUNT_TIME")
    p.add_argument("--save_predictions", action="store_true", help="TEST.SAVE_PREDICTIONS")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="experiment dir")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write DIR/trace.json and DIR/spans.json of the replications")
    p.add_argument("overrides", nargs="*", default=[],
                   help="with --preset model.FIELD=VALUE, train.FIELD=VALUE or test.FIELD=VALUE; "
                        "with --cfg dotted YAML keys, e.g. TEST.MM=true")
    return p.parse_args(argv)


def action_evaluator(dataset: str, num_classes: int, seed: int, device: torch.device,
                     checkpoint: str = "", hidden: int = 128, layers: int = 2
                     ) -> torch.nn.Module:
    """The dataset's action-recognition model (`test.py:391-412`): UESTC's
    ST-GCN, else the GRU of `hidden` units and `layers` layers
    (TEST.EVALUATOR_HIDDEN / EVALUATOR_LAYERS); its weights from
    `checkpoint` (the reference's keys), else its seeded random init with
    the graph's edge importances 1, as the JAX init has them. Frozen, in
    eval mode."""
    clf = (STGCN(num_class=num_classes) if dataset == "uestc"
           else MotionDiscriminator(hidden_size=hidden, num_layers=layers,
                                    output_size=num_classes))
    init_parameters_(clf, torch.Generator().manual_seed(seed))
    if isinstance(clf, STGCN):
        for p in clf.edge_importance:
            torch.nn.init.ones_(p)
    if checkpoint:
        load_reference_checkpoint(clf, checkpoint)
    return clf.requires_grad_(False).eval().to(device)


def evaluator_inputs(system: A2MSystem, clf: torch.nn.Module,
                     feats: torch.Tensor) -> torch.Tensor:
    """What the recognition model reads of (B, T, 150) features: the rot6d
    block (B, T, 24, 6) for the ST-GCN, FK joints (B, T, 72) for the GRU."""
    if isinstance(clf, STGCN):
        return feats[..., :POSE_FEATS].reshape(*feats.shape[:2], NUM_JOINTS, 6)
    return system.feats_to_joints(feats).flatten(2)


class Evaluator:
    """One evaluation run, set up as `test.py` sets it up; `run` evaluates."""

    def __init__(self, args: argparse.Namespace):
        preset, config = cli_config(args.preset, args.cfg, args.cfg_assets, args.overrides)
        tc = preset.test
        for name in ("batch_size", "replication_times", "checkpoint"):
            if getattr(args, name) is not None:
                tc = dataclasses.replace(tc, **{name: getattr(args, name)})
        tc = dataclasses.replace(tc, count_time=tc.count_time or args.count_time,
                                 save_predictions=tc.save_predictions or args.save_predictions)
        if tc.use_fused is not None:  # TEST.USE_FUSED (`test.py:73-87`) over model.use_fused
            preset = dataclasses.replace(
                preset, model=dataclasses.replace(preset.model, use_fused=tc.use_fused))
        self.preset = preset = dataclasses.replace(preset, test=tc)
        self.device, self.backend, self.mesh, self.joined = join_world(
            resolve_device(args.device))
        self.rank, self.world = process_rank()
        self.shard = batch_sharding(self.mesh)
        self.is_main = self.rank == 0
        self.trace_dir = args.trace if self.is_main else None
        self._batch_keys = itertools.count()
        full_float32()
        default_dir = (create_experiment_dir(config, phase="test") if config is not None
                       else os.path.join(OUT_ROOT, preset.name))
        self.exp_dir = os.path.abspath(args.out or default_dir)
        self._log_path = os.path.join(self.exp_dir, "test_log.txt")
        self.logger = None
        if self.is_main:
            os.makedirs(self.exp_dir, exist_ok=True)
            if config is not None:
                self.logger = create_logger(self.exp_dir, phase="test")
        self.stage, self.seed = preset.train.stage, preset.train.seed
        self.datamodule, self.system = build(preset, self.device)
        if self.datamodule.is_synthetic:
            self.log("dataset release not found -> synthetic datamodule")
        if tc.checkpoint:
            self.log(f"loaded checkpoint {load_weights(tc.checkpoint, self.system)}")
        else:
            self.log("no checkpoint given -> evaluating the seeded random init")
        world = f" world={self.world} backend={self.backend}" if self.mesh is not None else ""
        self.log(f"stage={self.stage} device={self.device} batch={tc.batch_size} "
                 f"replications={tc.replication_times}{world} out={self.exp_dir}")

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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict:
        """Every replication over the test split; returns {"stats", "replications",
        "metrics_path", "times"}. With `--trace DIR`, traced, and the spans'
        summary written to DIR/spans.json."""
        with device_trace(self.trace_dir, enabled=self.trace_dir is not None):
            replications, times = self._replicate()
        if self.trace_dir is not None:
            with open(os.path.join(self.trace_dir, "spans.json"), "w") as f:
                json.dump(summary(), f, indent=1)
            clear()
        return self._finish(replications, times)

    def _replicate(self):
        """(metrics of each replication, batch seconds) of the system's branch."""
        if isinstance(self.system, T2MSystem):
            return self._run_t2m()
        if isinstance(self.system, A2MSystem):
            return self._run_a2m()
        return self._run_ego()

    def _spanned(self, batches):
        """Each of `batches` inside a `batch` span keyed by its index in the run."""
        for item in batches:
            with span("batch", key=next(self._batch_keys)):
                yield item

    def _run_ego(self):
        """The ego replications: (metrics of each, batch seconds)."""
        system, tc = self.system, self.preset.test
        T = self.preset.model.motion_length
        fact = None if tc.fact == 1 else float(tc.fact)
        latent = (tc.batch_size, *self.preset.model.latent_dim)
        if tc.batch_size % self.world:
            raise ValueError(f"batch size {tc.batch_size} does not split over "
                             f"{self.world} ranks")
        cond_cache: Dict[int, torch.Tensor] = {}
        replications: List[Dict[str, float]] = []
        times: List[float] = []
        for rep in range(tc.replication_times):
            metric = EgoMetric(split=tc.split)
            gen = torch.Generator(device=self.device).manual_seed(self.seed + rep)
            for i, (batch_np, n_valid) in enumerate(
                    self._spanned(eval_batches(self.datamodule, "test", tc.batch_size))):
                # this rank's rows; the noise drawn at the whole batch's shape
                batch_np = shard_batch(self.mesh, batch_np)
                n_valid = valid_rows(n_valid, tc.batch_size, self.shard)
                batch = to_torch(batch_np, self.device)
                t0 = time.perf_counter()
                if self.stage == "vae":
                    eps = None if tc.mean else rows(
                        torch.randn(latent, generator=gen, device=self.device), self.shard)
                    feats = system.reconstruct(batch, eps=eps, sample_mean=tc.mean, fact=fact)
                else:
                    cond = None if tc.count_time else cond_cache.get(i)
                    if cond is None:
                        cond = system.encode_conditioning(batch)
                        if not tc.count_time:
                            cond_cache[i] = cond
                    z_init = rows(torch.randn(latent, generator=gen, device=self.device),
                                  self.shard)
                    noise = None
                    if not system.takes_kernel(cond.shape[1]) and system.cfg.eta > 0:
                        # the loop's per-step noise, at the whole batch's shape too
                        steps = system.cfg.num_inference_timesteps
                        noise = rows(torch.randn((latent[0], steps, *latent[1:]), generator=gen,
                                                 device=self.device), self.shard).transpose(0, 1)
                    feats = system.sample_from_cond(cond, z_init=z_init, noise=noise)
                out = system.eval_fk(batch, feats)
                self._sync()
                if tc.count_time:
                    times.append(time.perf_counter() - t0)
                mask = lengths_to_mask(batch["length"].long(), T)
                metric.update(out["joints_rst"][:n_valid], out["joints_ref"][:n_valid],
                              out["quat_rst"][:n_valid], out["quat_ref"][:n_valid],
                              mask[:n_valid])
                if tc.save_predictions and rep == 0:
                    self._save_predictions(i * tc.batch_size, out, batch_np, n_valid)
            replications.append(metric.compute(sync=self.world > 1))
            self.log(f"replication {rep}: " + " ".join(
                f"{k}={v:.3f}" for k, v in sorted(replications[-1].items())))
        return replications, times

    def _run_t2m(self):
        """The text-to-motion replications: (metrics of each, batch seconds)."""
        system, tc, dm = self.system, self.preset.test, self.datamodule
        evaluator = T2MEvaluator(nfeats=system.cfg.nfeats, ckpt=tc.evaluator_dir or None,
                                 glove_root=tc.word_vectorizer_path or None, device=self.device)
        self.log(f"loaded evaluator {tc.evaluator_dir}" if evaluator.is_pretrained else
                 "t2m evaluator running with its seeded random init "
                 "(test.evaluator_dir names the released or trained weights)")
        replications: List[Dict[str, float]] = []
        times: List[float] = []
        for rep in range(tc.replication_times):
            mr, tm2t = MRMetrics(), TM2TMetrics()
            gen = torch.Generator(device=self.device).manual_seed(self.seed + rep)
            for batch_np, n_valid in self._spanned(eval_batches(dm, "test", tc.batch_size)):
                texts = batch_np.get("text")
                batch_np = system.encode_captions(batch_np)
                batch = to_torch(batch_np, self.device)
                t0 = time.perf_counter()
                if self.stage == "vae":
                    feats = system.reconstruct(batch, generator=gen)
                else:
                    feats = system.sample(batch["text_emb"], cond_mask=batch.get("text_mask"),
                                          generator=gen)
                if tc.count_time:
                    self._sync()
                    times.append(time.perf_counter() - t0)
                lengths = batch_np["length"]
                mr.update(system.feats_to_joints(feats)[:n_valid].cpu().numpy(),
                          system.feats_to_joints(batch["motion"])[:n_valid].cpu().numpy(),
                          lengths[:n_valid])
                if texts is not None:
                    rec = dm.renorm4t2m(feats.cpu().numpy())
                    gt = dm.renorm4t2m(batch_np["motion"])
                    tm2t.update(evaluator.embed_text(texts)[:n_valid],
                                evaluator.embed_motion(rec, lengths)[:n_valid],
                                evaluator.embed_motion(gt, lengths)[:n_valid])
            results = mr.compute()
            if tm2t.text_embeddings:
                results.update(tm2t.compute())
            replications.append(results)
            self.log(f"replication {rep}: " + " ".join(
                f"{k}={v:.3f}" for k, v in sorted(results.items())))
        if tc.mm:
            mm = MMMetrics(mm_num_times=tc.mm_num_times)
            gen = torch.Generator(device=self.device).manual_seed(7)
            batch_np, mm_valid = next(eval_batches(dm, "test", min(tc.mm_num_samples,
                                                                   tc.batch_size)))
            batch = to_torch(system.encode_captions(batch_np), self.device)
            repeats = []
            for _ in range(tc.mm_num_repeats):
                feats = system.sample(batch["text_emb"], cond_mask=batch.get("text_mask"),
                                      generator=gen)
                repeats.append(feats.reshape(len(feats), -1)[:mm_valid].cpu().numpy())
            mm.update(np.stack(repeats, axis=1))
            value = mm.compute()
            replications = [dict(m, **value) for m in replications]
            self.log(f"MultiModality: {value['MultiModality']:.4f}")
        return replications, times

    def _run_a2m(self):
        """The action-to-motion replications: (metrics of each, batch seconds)."""
        system, tc = self.system, self.preset.test
        clf = action_evaluator(self.preset.dataset, system.cfg.num_classes, self.seed,
                               self.device, tc.evaluator_checkpoint, tc.evaluator_hidden,
                               tc.evaluator_layers)
        self.log(f"loaded evaluator {tc.evaluator_checkpoint}" if tc.evaluator_checkpoint else
                 "action evaluator running with its seeded random init "
                 "(test.evaluator_checkpoint names weights)")
        replications: List[Dict[str, float]] = []
        times: List[float] = []
        for rep in range(tc.replication_times):
            metric = ActionMetrics(num_classes=system.cfg.num_classes)
            gen = torch.Generator(device=self.device).manual_seed(self.seed + rep)
            for batch_np, n_valid in self._spanned(eval_batches(self.datamodule, "test",
                                                                tc.batch_size)):
                batch = to_torch(batch_np, self.device)
                t0 = time.perf_counter()
                feats = system.sample(batch["action"], generator=gen)
                if tc.count_time:
                    self._sync()
                    times.append(time.perf_counter() - t0)
                with torch.no_grad():
                    logits_gen, feats_gen = clf(evaluator_inputs(system, clf, feats),
                                                batch["length"])
                    _, feats_real = clf(evaluator_inputs(system, clf, batch["motion"]),
                                        batch["length"])
                metric.update(feats_gen[:n_valid].cpu().numpy(),
                              feats_real[:n_valid].cpu().numpy(),
                              logits_gen[:n_valid].cpu().numpy(), batch_np["action"][:n_valid])
            replications.append(metric.compute())
            self.log(f"replication {rep}: " + " ".join(
                f"{k}={v:.3f}" for k, v in sorted(replications[-1].items())))
        return replications, times

    def _finish(self, replications: List[Dict[str, float]], times: List[float]) -> Dict:
        """Statistics over the replications, `metrics_<stamp>.json`, `times.txt`
        (rank 0 writes them; its own batch times)."""
        tc = self.preset.test
        stats = get_metric_statistics(replications)
        for k, s in sorted(stats.items()):
            self.log(f"{k}: {s['mean']:.4f} +- {s['conf_interval']:.4f} "
                     f"[{s['min']:.4f}, {s['max']:.4f}]")
        path = os.path.join(self.exp_dir, f"metrics_{time.strftime('%Y-%m-%dT%H-%M-%S')}.json")
        if self.is_main:
            with open(path, "w") as f:
                json.dump(stats, f, indent=2)
        self.log(f"wrote {path}")
        if times and self.is_main:
            with open(os.path.join(self.exp_dir, "times.txt"), "w") as f:
                f.writelines(f"{t}\n" for t in times)
            per_sample = (float(np.mean(times[1:])) if len(times) > 1 else times[0]) / tc.batch_size
            self.log(f"mean time per sample (batch {tc.batch_size}): {per_sample:.6f} s "
                     f"({1.0 / per_sample:.1f} samples/s)")
        leave_world(self.joined)
        return {"stats": stats, "replications": replications, "metrics_path": path,
                "times": times}

    def _save_predictions(self, first: int, out: Dict, batch_np: Dict, n_valid: int) -> None:
        """One npy of joints per sequence, prediction and ground truth (the
        `save_npy` contract, `modeltype/base.py:215-256`); rank 0 writes
        every rank's valid rows (`first` is the whole batch's first index)."""
        rst, ref = out["joints_rst"].cpu().numpy(), out["joints_ref"].cpu().numpy()
        lengths = np.asarray(batch_np["length"])
        mine = (first + self.shard[0] * len(rst), rst[:n_valid], ref[:n_valid],
                lengths[:n_valid])
        parts = [mine]
        if self.mesh is not None:
            parts = [None] * self.world
            dist.all_gather_object(parts, mine)
        if not self.is_main:
            return
        pred_dir = os.path.join(self.exp_dir, "predictions")
        os.makedirs(pred_dir, exist_ok=True)
        for start, rst, ref, lengths in parts:
            for b, L in enumerate(lengths):
                np.save(os.path.join(pred_dir, f"pred_{start + b}.npy"), rst[b, :int(L)])
                np.save(os.path.join(pred_dir, f"gt_{start + b}.npy"), ref[b, :int(L)])


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return Evaluator(parse_args(argv)).run()


if __name__ == "__main__":
    main(sys.argv[1:])
