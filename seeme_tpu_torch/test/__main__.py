"""Evaluation CLI for the ego configs: the EgoBody/GIMO branch of `test.py`
(`test.py:80-205`).

    python -m seeme_tpu_torch.test --preset NAME [--batch_size N]
        [--replication_times N] [--checkpoint PATH] [--count_time]
        [--save_predictions] [--device cpu] [--out DIR]
        [model.FIELD=VALUE ...] [test.FIELD=VALUE ...]

NAME is a preset of `config/egobody.py`. The system is built from it and,
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
`experiments/torch/<preset name>`).

It runs on the card unless `--device cpu` is given, and raises when there
is no card. On the card, float32 products and convolutions run in full
float32 (TF32 off).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import full_float32, resolve_device
from ..config.egobody import OUT_ROOT, PRESETS, apply_overrides
from ..core.masks import lengths_to_mask
from ..core.smpl import synthetic_smpl
from ..data.batch import eval_batches
from ..data.registry import get_datamodule
from ..data.synthetic import to_torch
from ..eval.metrics import EgoMetric
from ..eval.stats import get_metric_statistics
from ..models.seeme import SeeMeSystem
from ..train.checkpoint import load_weights


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.test")
    p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p.add_argument("--batch_size", type=int, default=None, help="TEST.BATCH_SIZE")
    p.add_argument("--replication_times", type=int, default=None, help="TEST.REPLICATION_TIMES")
    p.add_argument("--checkpoint", default=None, help="TEST.CHECKPOINTS")
    p.add_argument("--count_time", action="store_true", help="TEST.COUNT_TIME")
    p.add_argument("--save_predictions", action="store_true", help="TEST.SAVE_PREDICTIONS")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="experiment dir")
    p.add_argument("overrides", nargs="*", default=[],
                   help="model.FIELD=VALUE, train.FIELD=VALUE or test.FIELD=VALUE")
    return p.parse_args(argv)


class Evaluator:
    """One evaluation run, set up as `test.py` sets it up; `run` evaluates."""

    def __init__(self, args: argparse.Namespace):
        preset = apply_overrides(PRESETS[args.preset](), args.overrides)
        tc = preset.test
        for name in ("batch_size", "replication_times", "checkpoint"):
            if getattr(args, name) is not None:
                tc = dataclasses.replace(tc, **{name: getattr(args, name)})
        tc = dataclasses.replace(tc, count_time=tc.count_time or args.count_time,
                                 save_predictions=tc.save_predictions or args.save_predictions)
        self.preset = preset = dataclasses.replace(preset, test=tc)
        self.device = resolve_device(args.device)
        full_float32()
        self.exp_dir = os.path.abspath(args.out or os.path.join(OUT_ROOT, preset.name))
        os.makedirs(self.exp_dir, exist_ok=True)
        self._log_path = os.path.join(self.exp_dir, "test_log.txt")
        self.stage, self.seed = preset.train.stage, preset.train.seed
        cfg = preset.model
        self.datamodule = get_datamodule(preset.dataset, cfg.condition, cfg.motion_length,
                                         cfg.scene_points, image_size=cfg.image_size)
        if self.datamodule.is_synthetic:
            self.log("dataset release not found -> synthetic datamodule")
        self.system = SeeMeSystem(cfg, synthetic_smpl(n_verts=6890), self.datamodule.mean,
                                  self.datamodule.std, device=self.device, seed=self.seed)
        if tc.checkpoint:
            self.log(f"loaded checkpoint {load_weights(tc.checkpoint, self.system)}")
        else:
            self.log("no checkpoint given -> evaluating the seeded random init")
        self.log(f"stage={self.stage} device={self.device} batch={tc.batch_size} "
                 f"replications={tc.replication_times} out={self.exp_dir}")

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        with open(self._log_path, "a") as f:
            f.write(line + "\n")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict:
        """Every replication over the test split; returns {"stats", "replications",
        "metrics_path", "times"}."""
        system, tc = self.system, self.preset.test
        T = self.preset.model.motion_length
        fact = None if tc.fact == 1 else float(tc.fact)
        cond_cache: Dict[int, torch.Tensor] = {}
        replications: List[Dict[str, float]] = []
        times: List[float] = []
        for rep in range(tc.replication_times):
            metric = EgoMetric(split=tc.split)
            gen = torch.Generator(device=self.device).manual_seed(self.seed + rep)
            for i, (batch_np, n_valid) in enumerate(
                    eval_batches(self.datamodule, "test", tc.batch_size)):
                batch = to_torch(batch_np, self.device)
                t0 = time.perf_counter()
                if self.stage == "vae":
                    feats = system.reconstruct(batch, generator=gen, sample_mean=tc.mean,
                                               fact=fact)
                else:
                    cond = None if tc.count_time else cond_cache.get(i)
                    if cond is None:
                        cond = system.encode_conditioning(batch)
                        if not tc.count_time:
                            cond_cache[i] = cond
                    feats = system.sample_from_cond(cond, generator=gen)
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
            replications.append(metric.compute())
            self.log(f"replication {rep}: " + " ".join(
                f"{k}={v:.3f}" for k, v in sorted(replications[-1].items())))

        stats = get_metric_statistics(replications)
        for k, s in sorted(stats.items()):
            self.log(f"{k}: {s['mean']:.4f} +- {s['conf_interval']:.4f} "
                     f"[{s['min']:.4f}, {s['max']:.4f}]")
        path = os.path.join(self.exp_dir, f"metrics_{time.strftime('%Y-%m-%dT%H-%M-%S')}.json")
        with open(path, "w") as f:
            json.dump(stats, f, indent=2)
        self.log(f"wrote {path}")
        if times:
            with open(os.path.join(self.exp_dir, "times.txt"), "w") as f:
                f.writelines(f"{t}\n" for t in times)
            per_sample = (float(np.mean(times[1:])) if len(times) > 1 else times[0]) / tc.batch_size
            self.log(f"mean time per sample (batch {tc.batch_size}): {per_sample:.6f} s "
                     f"({1.0 / per_sample:.1f} samples/s)")
        return {"stats": stats, "replications": replications, "metrics_path": path,
                "times": times}

    def _save_predictions(self, first: int, out: Dict, batch_np: Dict, n_valid: int) -> None:
        """One npy of joints per sequence, prediction and ground truth (the
        `save_npy` contract, `modeltype/base.py:215-256`)."""
        pred_dir = os.path.join(self.exp_dir, "predictions")
        os.makedirs(pred_dir, exist_ok=True)
        rst, ref = out["joints_rst"].cpu().numpy(), out["joints_ref"].cpu().numpy()
        for b in range(n_valid):
            L = int(batch_np["length"][b])
            np.save(os.path.join(pred_dir, f"pred_{first + b}.npy"), rst[b, :L])
            np.save(os.path.join(pred_dir, f"gt_{first + b}.npy"), ref[b, :L])


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return Evaluator(parse_args(argv)).run()


if __name__ == "__main__":
    main(sys.argv[1:])
