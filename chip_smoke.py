#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: EgoBody (SEE-ME, its
image-conditioned, GIMO and interactee-only configs, both training stages,
the test CLI), HumanML3D text-to-motion (sampling, both training stages,
the test CLI, the diffusion-only model and the token text mode), the
ProHMR-Scene and EgoHMR perception stack's evaluation and training paths,
HumanAct12 / UESTC action-to-motion (sampling, both training stages, the
test CLI with either evaluator), multi-token latents through both DDIM
kernels with a multi-token EgoBody config from the shipped YAML, the
root entry points `demo`, `scene_encoder` and `fit` through `--cfg`, the
SMPL model file on those paths, the evaluators trained by
`tools.train_evaluator` and used by the test CLI, the HumanML3D feature
pipeline with RIFKE and APE / AVE, host-to-device prefetching, data
parallelism, the train CLI's two dispatch routes and the model axis, and
the configuration switches of the sixteenth slice (the `ddim_sample` loop
routes, the perception models' camera switches, `TRAIN.RESUME`).

    python3 chip_smoke.py

Phases, each printing one line with its seconds as soon as it ends:
  1. the card: `nvidia-smi` name and power limit, `torch.cuda.get_device_name`;
  2. the nvcc build of `seeme_tpu_torch/csrc/*.cu` (one nvcc per source, in
     parallel), with ptxas' registers, spills and wgmma/setmaxnreg notes for
     every kernel;
  3. each CUDA kernel against its plain PyTorch version at its path's
     shapes (PointNet blocks at B=64, N=20 000, H=512; the MD DDIM-50 kernel
     at B=64, guidance 1.0 and 2.5, and its grid entry at both; the token
     DDIM-50 kernel at the T2M width, B=64, guidance 1.0 and 7.5; both DDIM
     kernels again at B=1, one request, at their path's guidance): max-abs
     and relative error against the stated tolerance, the kernel's and the
     plain version's ms (CUDA events, after a warm-up), and the least time
     the card could take (bound_ms: operations at the bf16 tensor-core rate
     or bytes at the HBM rate; bound_f32_ms with the f32 rate instead, the
     bound of the earlier f32-FMA kernels); for the PointNet blocks also
     the achieved TFLOP/s and floor_ms, the least time of their split-bf16
     scheme (three bf16 products for each f32 one), and their launch plan (points a CTA,
     cluster, ring slots, shared memory, clusters that fit); for each DDIM
     launch, its cluster configuration (CTAs a cluster, grid, clusters that
     fit at once, shared memory); every launch must be a cluster of at least
     2 CTAs that fits;
  4. the EgoBody slice at full width on a seeded synthetic batch of 64:
     `encode_conditioning` -> `sample_from_cond` -> `eval_fk` -> ego
     metrics, with every kernel's launch count set to 0 just before and read
     just after (expected: input block 1, split block 3, DDIM 1); the same
     weights on the CPU's plain path at a small input as the reference; and
     `sample_from_cond` again with `fused_variant="grid"` (grid entry 1,
     features as the loop variant's);
  5. the T2M slice at full width (`T2MConfig()`, B=64, 196 x 263): pooled
     text embeddings -> `T2MSystem.sample` -> `feats_to_joints` ->
     `MRMetrics`, counted the same way (expected: token kernel 1, nothing
     else); then the same weights on the CPU's plain path at B=2, with the
     joints' gap split into the RIC recovery's own and the features' carried;
  6. training stage 1 (`vae_egobody`, full width, B=64) through the CLI's
     `main` for 2 epochs of the synthetic 256-sample split into a temporary
     directory: losses finite, the last epoch's mean below the first's, ms
     per step (CUDA events, after one warm-up step), peak memory, no kernel
     launched;
  7. training stage 2 (`mld_egobody`) set up as `main` sets it up, with the
     stage-1 checkpoint as its pretrained VAE: the frozen scene-feature cache
     (expected: input block 5, split block 3 x 5, over 256 + 64 samples in
     chunks of 64), then 2 epochs and a validation (expected: no launch);
     `vae.*` and `proscene.*` bitwise as loaded, the denoiser and
     `output_scene.1.*` changed, the val loss with fixed draws and dropout
     off lower after training than before; ms per step, peak memory, the
     cache fill's time and the PointNet kernels' device time inside it
     (`torch.profiler`, on a second fill that is not counted);
  8. 2 stage-2 steps at guidance 2.5 (no cache; expected per step: input
     block 1, split block 3);
  9. `sample_from_cond` on the trained stage-2 weights (expected: DDIM 1),
     the kernel within 1e-3 of max|z| of its plain version on the same
     updated weights, which shows the kernel-layout copies followed AdamW's
     in-place update; the stage-1 model (`vae_egobody`, MD_TRANS false: the
     token-concat stack) samples once through kernel 5 (token kernel 1),
     within 1e-3 of max|z| of its plain version;
 10. one step of each stage at the CPU tests' small size (d=32, 3 layers, 64
     points, B=3, dropout 0) on the card and on the CPU with the same draws:
     loss within 1e-4 relative, every gradient within 1e-3 of its tensor's
     max |g|, the updated parameters alike; TF32 must be off;
 11. the image-conditioned SEE-ME (`mld_egobody_image`) at full width (B=64,
     20 000 points, 224x224 crops): kernel 3 at 3 condition tokens against
     its plain version at guidance 1 and 2.5 (ms, bound, launch plan), the
     ResNet50's ms, the counted slice (expected: input block 1, split block
     3, DDIM 1, one ResNet50 forward), the slice's time split part by part,
     and the card path against the CPU's plain path at B=2, 512 points,
     64x64 crops (features, joints, the four `EgoMetric` means);
 12. GIMO (`mld_gimo`, 69 features) and `mld_interactee` (kernel 3 at one
     condition token, timed) the same way, sampling and FK counted;
 13. stage 2 of `mld_egobody_image` with the stage-1 checkpoint: the feature
     cache (expected: input block 5, split block 15, ResNet50 forwards 5; its
     seconds and the ResNet50's device time inside it);
 14. its cached steps and validation (expected: nothing launched, no
     ResNet50 forward; `output_images` has a gradient and trains; the image
     encoder, VAE and PointNet bitwise unchanged);
 15. the test CLI (`seeme_tpu_torch.test`) on that checkpoint, 2
     replications over the 64-sample synthetic test split (expected: the
     condition encode once, input block 1, split block 3, ResNet50 1, DDIM 2)
     with finite mean / CI / min / max in its metrics JSON;
 16. set-up of ProHMR-Scene at full width (`ProHMRConfig()`: flow hidden
     1024 x 4 layers x depth 2, context 2566; synthetic SMPL with 6890
     vertices) and a correlated synthetic batch of 64 (20 000 scene points,
     224 x 224 crops);
 17. both PointNet kernels at hidden width 256 (the perception stack's
     scene encoder) against their plain versions at B=64, N=20 000 and at
     B=1, N=1000 and B=3, N=1077 (ragged tiles): errors, ms, bound, split-bf16
     floor, shares, TFLOP/s and launch plans;
 18. ProHMR-Scene `forward_step` (4 samples, the mode first) and the CLI's
     metrics on the mode, counted (expected: H=256 input block 1, split block
     3, nothing else), its parts timed alone (ResNet50, PointNet, flow, SMPL
     over 256 bodies) and the whole step, and the card against the CPU's
     plain path at B=2 (512 points, 224 x 224 crops, shared base noise);
 19. EgoHMR `sample` at full width (`EgoHmrConfig()`: GCN 1024 x 4, ddim50,
     each step's two predictions in one GCN call) the same way (expected:
     H=256 input block 1, split block 3; parts ResNet50, PointNet, the 50
     GCN steps, SMPL), card vs CPU with injected noise;
 20-21. `python -m seeme_tpu_torch.test_prohmr_scene` and `test_egohmr` at
     full width on the 16-example test split (one batch, 20 000 points),
     counted the same way;
 22. the HumanML3D text-to-motion model's stage 1 (`vae_humanml3d`, B=64, 196
     x 263) through the CLI's `main` for 2 epochs of the synthetic 256-sample
     split: ms per step, peak memory, device idle share, falling epoch
     losses, no launch, and one step card vs CPU at the small size;
 23. stage 2 (`mld_humanml3d`) over that checkpoint: the same report, the VAE
     bitwise unchanged, the denoiser changed, the fixed-draw val loss lower;
     then `sample` on the trained weights at the preset's guidance 1.0 (64
     condition rows) and at 7.5 (128): one token-kernel launch each, the
     kernel within 1e-3 of max|z| of its plain version and timed at that
     shape, and card vs CPU at B=2 on features and on joints recovered in
     float64 on both sides;
 24. the test CLI on that checkpoint, 2 replications with `--count_time` and
     MultiModality at 32 x 8 (expected: token kernel 2 x batches + 8), finite
     MR, TM2T and MultiModality statistics, `times.txt` and the metrics
     JSON; the stage-1 preset reconstructs with no launch;
 25. the diffusion-only model (`novae_humanml3d`, trans_dec 9 x 512): a
     training step at B=64 (ms, peak memory), then `sample` at B=32 x 196 x
     263, 50 steps at guidance 7.5 through the loop (its wall time, no
     launch), card vs CPU at B=2 on features and on the RIC recovery of the
     same features (the joints' whole gap printed, not gated: on a barely
     trained model's large features RIC magnifies the features' gap);
 26. the token text mode: the clip_hidden fallback's 77 tokens with their
     mask through the loop (no launch), card vs CPU at B=2 as in 25;
 27. the fused PointNet's backward (`ops/pointnet_fused.py`, kernels 1-2
     forward, the eager twin's chunked recompute backward) at H=256, B=64
     and H=512, B=16, both with 20 000 points: the gradients of a seeded
     projection of the output against the plain twin's, each parameter
     within TRAIN_GRAD_RTOL of its max |g| (expected launches 1 / 3 at that
     width), forward and backward ms of both, peak memory of both;
 28. ProHMR-Scene training through `train_prohmr_scene.main` at
     `ProHMRConfig()` with the CLI's defaults (B=8, 1024 points, 2 epochs of
     the 64-example synthetic split, 16 G + D steps): the ActNorm start,
     finite G and D losses, `scene_enc`, the backbone's statistics and the
     discriminator changed, H=256 launches 1 / 3 in each G step and in the
     ActNorm start's context and none in a D step, the smallest batch-norm
     variance; one G and one D step on the CLI's weights card vs CPU at
     the CLI's B=8, 1024 points with shared draws, the card's ReLU
     decisions replayed in the CPU's steps, and in the scene encoder's
     recompute its max-pools' choices of point too (`relu_decisions`: a
     decision within rounding of 0, or a near tie, that went the other way
     would move a gradient by a percent or more of its max; the loss within TRAIN_LOSS_RTOL,
     every gradient within TRAIN_GRAD_RTOL); then a G + D step at B=64,
     20 000 points, 224 x 224 (ms, peak memory, device idle share);
     `test_prohmr_scene --checkpoint` on the saved file (1 / 3);
 29. EgoHMR training through `train_egohmr.main` at `EgoHmrConfig()` the
     same way (16 steps, 1 / 3 each; the scene encoder and the GCN's
     statistics changed), card vs CPU with one sample's image block
     dropped, its step at B=64, and `test_egohmr --checkpoint`;
 30. the action-to-motion sampling slice at full width (`mld_humanact12`'s
     model: latent 256, ff 128, 5 layers, 60 x 150), 12 classes (HumanAct12)
     and 40 (UESTC), each at guidance 1.0 (shipped) and 7.5, B=64: labels
     -> `A2MSystem.sample` -> FK or the rot6d block -> the dataset's
     evaluator (GRU or ST-GCN), counted (expected: token kernel 1, nothing
     else); kernel 5 against its plain version on the same condition rows
     (1e-3 of max|z|), its ms, plain ms and bound; the parts alone (embed,
     kernel, decode, FK, evaluator; CUDA events); the card against the
     CPU's plain path at B=2 (features and joints within 1e-3);
 31. both a2m training stages through the CLI (`vae_humanact12`, then
     `mld_humanact12 --pretrained_vae`, 4 epochs of the 240-sample synthetic
     split at B=64): no launch, stage 1's epoch loss falling, stage 2's
     fixed-draw val loss falling, the VAE bitwise as loaded, the denoiser
     and `embed_action` changed; ms per step, peak memory, device idle
     share; one step of each stage card vs CPU at the CPU tests' size;
 32. the test CLI on trained checkpoints (`mld_humanact12` with the GRU,
     `mld_uestc`, one epoch over the stage-1 VAE, with the ST-GCN), 2
     replications each (expected: token kernel 2 each), finite FID /
     accuracy / Diversity / MultiModality; both evaluators' ms at B=64;
 33. kernel 3 at latent [T, 256], T = 1, 2 and 10 (NC=2, B=64, 50 steps,
     guidance 1.0 and 2.5, T = 1 timed again on the same weights): error
     against the plain version (1e-3 of max|z|), ms, plain ms, bound and f32
     bound from the operation count at that T, launch plan with the
     samples a cluster carries;
 34. kernel 5 the same way at the T2M shape (text 768, guidance 7.5) and
     the shipped preset's (text 256, guidance 1.0); `T2MSystem.sample` at
     latent [2, 256] and [10, 256], B=64 (expected: token kernel 1 at that
     T, counted by token count);
 35. `configs/config_mld_egobody.yaml` with `model.latent_dim=[2,256]`
     through the port's loader: stage 1 and stage 2 through the train CLI's
     `--cfg` (falling epoch loss; cache fill 5 / 15; fixed-draw val loss
     falling), the stage-1 model (MD_TRANS false in its YAML: the
     token-concat stack) sampling at T = 2 (expected: token kernel at T=2
     once; the kernel within 1e-3 of max|z| of its plain version), the
     sampling slice on the trained weights (encode -> kernel
     3 -> decode -> FK -> `EgoMetric`; expected: input block 1, split block
     3, kernel 3 at T=2 once), card vs CPU at B=2, and `sample_from_cond`
     at latent [10, 256] (kernel 3 at T=10 once);
 36. the same config with `model.fused_variant=grid`: `ddim_fused` at T=2
     once, not the grid entry, features equal to the loop variant's;
 37. `python -m seeme_tpu_torch.demo --cfg config_mld_egobody.yaml --mesh`
     (expected: 1 / 3 / kernel 3 once): samples, ground truth, meshes,
     faces, finite;
 38. the demo with `config_mld_humanml3d.yaml` and an `--example` file
     (kernel 5 once), `--task random_sampling` (nothing) and
     `config_mld_humanact12.yaml --actions 0,3,7` (kernel 5 once);
 39. `python -m seeme_tpu_torch.scene_encoder` (20 000 points; kernels 1 / 2
     at H=256 once / three times) against the plain twin (1e-4 of max|out|);
 40. `python -m seeme_tpu_torch.fit` over the ego demo's first sample, 100
     Adam steps on the card: falling loss, finite parameters, host time;
 41. a 6890-vertex SMPL file written in the MPI `.pkl` layout and as the
     `.npz` cache, read on the card bitwise as written; the test CLI with
     `--cfg config_mld_egobody.yaml model.smpl_path=<pkl>` at B=64
     (expected: 1 / 3 / kernel 3 once) and that slice card vs CPU at B=2;
 42. `fit --smpl_path <pkl>` and the a2m test CLI with the file (kernel 5
     once);
 43-45. `python -m seeme_tpu_torch.tools.train_evaluator` for the
     HumanAct12 GRU (12 epochs, val accuracy > 0.3), the UESTC ST-GCN (3
     epochs, falling loss) and the HumanML3D TM2T trio (`--debug`, 150
     epochs, test R@1(32) > 0.15): no launch while training, ms a step and
     the device idle share, each file reloaded by the test CLI's loader
     with outputs bitwise the trainer's, then the test CLI through `--cfg`
     with it (kernel 5 once, "loaded evaluator" logged);
 46. `preprocess_humanml` on the card and on the CPU over seeded joints
     (22 and 21 joints, 196 frames): features within 1e-5 of max, the RIC
     recovery against the canonical joints, RIFKE and APE / AVE card vs CPU;
 47. stage-2 EgoBody training at B=64 with the raw 20 000-point scene per
     batch through `run_epoch`'s prefetching: each prefetched batch bitwise
     its host batch, the terms of 6 steps (after a warm-up step, in halves
     run prefetched / synchronous / synchronous / prefetched) within 1e-6 of
     a synchronous loop's on a twin trainer, ms a step and idle share of
     both, and one batch's pageable and pinned copies alone;
 48-54. DEBUG on the `--cfg` route, `demo --render`, the exporters, `tsne`,
     `flops`, `preflight --end-to-end`, the text encoder (`slice13_phases`);
 55. data parallelism: stage 2 of `config_mld_egobody.yaml` (full width,
     B=64, 20 000 points, dropout 0) through `python -m
     torch.distributed.run --nproc_per_node 2` of this script's
     `--ddp-worker` mode, which runs the train CLI's `main` with counting
     hooks, on the one card (gloo; NCCL where there are two cards or more),
     against the same run in one process:
     the first step's gradients within 1e-5 of each max |g|, the loss
     trajectory within 1e-4, the validations, the parameters bitwise alike
     across the ranks after every epoch, each rank's cache fill 5 / 15, one
     checkpoint directory; ms a step, peak memory, idle share per rank;
 56. the same at `--nproc_per_node` = the card count over NCCL;
 57. the ego test CLI on 55's one-process checkpoint at 2 ranks against one
     process: MPJPE / ROOT / HEAD / ACCL within 1e-6 relative, each rank
     input block 1, split block 3 and kernel 3 once a batch and
     replication at 32 rows;
 58. the train CLI's two dispatch routes in one process (`dispatch_phases`):
     stage 2 of `config_mld_egobody.yaml` (B=64, 20 000 points, dropout 0,
     2 epochs of 4 steps) with the cache, without it and at guidance 2.5 on
     the card's defaults (the split on the card, 8 steps a fetch) against
     the host route at 1: routes and log lines, parameters and losses
     within 1e-6 of max, 2 fetches an epoch, launches alike (1 / 3 a step
     without the cache); ms a step and idle share of each route, the
     split's GB; one epoch each of the HumanML3D and HumanAct12 configs the
     same way;
 59. one torchrun of two ranks (`--ddp-worker slice15`): the train CLI of
     phase 55 on the device route against 55's one process, with 55's
     gates and 2 fetches an epoch;
 60. in the same ranks, the train CLI at `MESH.MODEL_AXIS=2` (a 1 x 2 mesh)
     against 55's one process; then `shard_params` on `SeeMeConfig()` at
     B=64: the loss within 1e-4 and the parameters within 1e-5 of max of
     the replicated step's, half the storage and half the AdamW moments of
     the sharded tensors a rank, kernel 3's sample from the gathered
     operands within 1e-6 of the unsharded one's and following the update;
 61. `config_mld_egobody.yaml` at B=64 with 20 000 points as shipped (kernel
     3 once) and with `model.scheduler.eta=0.5`, `model.use_fused=false`
     and `model.num_head=4`, which sample through the `ddim_sample` loop
     (PointNet 1 / 3, no DDIM kernel): each route's `sample_from_cond` ms
     (CUDA events), finite outputs, and each loop route card vs CPU at B=2
     with 512 points and its initial and per-step noise injected (latents
     within 1e-3 of max|z|, features within 1e-3 of max);
 62. ProHMR-Scene `forward_step` with every camera switch off and the glow
     without batch norm at B=64: kernels 1-2 at H=256 (1 / 3), ms, peak
     memory, card vs CPU as phase 18;
 63. an EgoHMR training step with every camera switch off and
     `only_mask_img_cond=False`: card vs CPU at the CLI's B=8 with 1024
     points, one sample's whole condition dropped, with phase 29's gates
     and ReLU-decision replay; then at B=64 with 20 000 points, 1 / 3 a
     step, ms a step and peak memory;
 64. `--cfg config_vae_egobody.yaml TRAIN.RESUME=<exp dir>`: the run
     continues from the saved step and epoch and deletes no step file; a
     mistyped TRAIN.RESUME raises FileNotFoundError with the directory as
     it was.
 65. kernel 5 at MLD's published HumanML3D denoiser (9 layers, 4 heads,
     ff 1024, text 768, guidance 7.5, B=64), then at 2 heads and ff 512:
     `T2MSystem.sample` with the counts reset just before (expected: token
     kernel 1 once, never the `ddim_sample` loop), the kernel against its
     plain version (1e-3 of max|z|), its launch plan (13 clusters of 5
     samples, one wave), ms, plain ms and bound (it runs after phase 36);
 66. the GCN kernels (`csrc/gcn.cu`) at EgoHMR's widths (B=64, GCN 1024 x
     4), on phase 19's model and batch: one step and the final prediction
     against the plain path on the card (1e-4 of max |x|), one hidden conv's
     ms beside its bound and the split-TF32 floor, its eager block's, a
     whole step's (2 x 4 + 2 launches), the eager step's and the 50 steps'
     with the final prediction (it runs after phase 19);
Phases 6-8, 13-14, 47 and 55-57 time and gate the host route at one step a
fetch (`HOST_ROUTE`, `HOST_ROUTE_CFG`); the other training phases take the
card's default route.
Then one JSON line of per-kernel numbers (each kernel's launches on every
path; kernel 3's numbers at 1 and 3 condition tokens; the PointNet kernels
at H=256 as rows of their own, `pointnet_*_block_h256`, whose main path is
the ProHMR-Scene slice; the PointNet rows carry phase 27's `backward`
numbers; kernel 5 also as `ddim_tok_t1_a2m`, at the shipped a2m shape,
whose main path is phase 30's HumanAct12 slice at guidance 1.0; kernels 3
and 5 at T = 2 and 10 as `ddim_md_t2`, `ddim_md_t10`, `ddim_tok_t2`,
`ddim_tok_t10`, with guidance 2.5 / the preset's shape beside them and the
T = 1 time of the same phase; their main paths are phases 34-35; kernel 5
at MLD's widths as `ddim_tok_mld`, 4 heads and ff 1024, with 2 heads and ff
512 beside it, whose main path is phase 65's `T2MSystem.sample`; the GCN
kernels as `gcn_fused`, one hidden conv's numbers with phase 66's step times
beside them, whose main path is phase 19's `EgoHmr.sample`), the
card's name and power limit, and, last, `{"ok": true, "device": {...}}`.
Any failed check exits non-zero at once. Random weights: the seeded init
plus a seeded perturbation, so the zero-initialized output projections
carry signal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

BATCH = 64
SEED = 0
PEAK_FLOPS = 989e12      # H100 SXM, bf16 tensor cores, dense: what the card can do
PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores (bound_f32_ms)
PEAK_TF32_FLOPS = 494.5e12  # H100 SXM, TF32 tensor cores, dense: the GCN kernels' split scheme
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
SPLIT_PRODUCTS = 3       # the PointNet kernels' bf16 products per f32 product (floor_ms)
POINTNET_RTOL = 1e-4     # max |kernel - plain| / max |plain|
DDIM_RTOL = 1e-3         # max |kernel - plain| / max |z|
SLICE_RTOL = 1e-3        # card slice vs CPU slice (or grid vs loop), relative to max |features|
TRAIN_LOSS_RTOL = 1e-4   # one train step's loss, card vs CPU
TRAIN_GRAD_RTOL = 1e-3   # its gradients, card vs CPU, relative to each tensor's max |g|
GRAD_FLOOR = 1e-8        # absolute bound for a gradient that is zero but for f32 rounding
TRAIN_LR = 1e-3          # the card-vs-CPU step's learning rate
HMR_POINTS = 20000       # the perception stack's scene points at full width
EVAL_T2M_EPOCHS = 150    # the TM2T trio's epochs on the --debug split (the JAX test's count)
FEATURE_RTOL = 1e-5      # card vs CPU features of preprocess_humanml, relative to max |feat|
PREFETCH_STEPS = 6       # timed stage-2 steps of the prefetching epoch and of the synchronous loop
# the host route, one fetch a step, which phases 6-8, 13-14, 47 and 55-57 time and gate
HOST_ROUTE = ["train.device_data=False", "train.steps_per_dispatch=1"]
HOST_ROUTE_CFG = ["TRAIN.DEVICE_DATA=false", "TRAIN.STEPS_PER_DISPATCH=1"]
DISPATCH_RTOL = 1e-6     # device route vs host route: parameters and losses, relative to max
SHARD_LOSS_RTOL = 1e-4   # the model-axis sharded step's loss vs the replicated step's
SHARD_PARAM_RTOL = 1e-5  # its parameters after one AdamW step, relative to each tensor's max

_t0 = time.perf_counter()


def phase(msg: str, t_start: float) -> None:
    print(f"[{time.perf_counter() - t_start:8.2f} s | {time.perf_counter() - _t0:8.2f} s total] "
          f"{msg}", flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn):
    """(fn(), its ms by CUDA events): one run, for a plain version whose
    output is compared too."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(name: str, got, want, scale: float, rtol: float) -> float:
    import torch

    require(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    err = float((got - want).abs().max())
    ok = err <= rtol * scale
    print(f"    {name}: max_abs_err {err:.3e}, relative {err / scale:.3e} "
          f"(tolerance {rtol:.0e} x {scale:.4g}) {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name} disagrees with its plain version")
    return err


def counter_table(pfu, dfu) -> dict:
    """Each kernel of the JSON line: its wrapper, and what it counts by: the
    hidden width of a PointNet instantiation (the wrappers count launches by
    width too), or a DDIM kernel's latent token count ("tokens", T); None
    counts every launch of the wrapper."""
    from seeme_tpu_torch.ops import gcn_fused as gfu

    return {"pointnet_input_block": (pfu.fused_input_block, 512),
            "pointnet_split_block": (pfu.fused_split_block, 512),
            "ddim_md_t1": (dfu.ddim_fused, ("tokens", 1)),
            "ddim_fused_grid": (dfu.ddim_fused_grid, None),
            "ddim_tok_t1": (dfu.ddim_fused_tok, ("tokens", 1)),
            "pointnet_input_block_h256": (pfu.fused_input_block, 256),
            "pointnet_split_block_h256": (pfu.fused_split_block, 256),
            "ddim_md_t2": (dfu.ddim_fused, ("tokens", 2)),
            "ddim_md_t10": (dfu.ddim_fused, ("tokens", 10)),
            "ddim_tok_t2": (dfu.ddim_fused_tok, ("tokens", 2)),
            "ddim_tok_t10": (dfu.ddim_fused_tok, ("tokens", 10)),
            "gcn_fused": (gfu.gcn_fused, None)}


def zero_counters(counters: dict, pfu) -> None:
    """Every launch count of `counter_table` set to 0."""
    for fn, key in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_tokens"):
            fn.launches_by_tokens = {}
        if isinstance(key, int):
            fn.launches_by_width = dict.fromkeys(pfu.WIDTHS, 0)


def read_counters(counters: dict, pfu, dfu) -> dict:
    """Each kernel's launches since `zero_counters`; fails unless each
    wrapper's total is the sum of its counts by width or token count."""
    for fn in (pfu.fused_input_block, pfu.fused_split_block):
        require(fn.launches == sum(fn.launches_by_width.values()),
                f"{fn.__name__}: {fn.launches} launches, by width {fn.launches_by_width}")
    for fn in (dfu.ddim_fused, dfu.ddim_fused_tok):
        require(fn.launches == sum(fn.launches_by_tokens.values()),
                f"{fn.__name__}: {fn.launches} launches, by tokens {fn.launches_by_tokens}")

    def read(fn, key):
        if key is None:
            return fn.launches
        if isinstance(key, tuple):
            return fn.launches_by_tokens.get(key[1], 0)
        return fn.launches_by_width[key]

    return {name: read(fn, key) for name, (fn, key) in counters.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from seeme_tpu_torch.core.smpl import synthetic_smpl
        from seeme_tpu_torch.data.humanml import SyntheticT2MDataset
        from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
        from seeme_tpu_torch.eval.metrics import ego_sequence_metrics, filtered_means
        from seeme_tpu_torch.eval.t2m_metrics import MRMetrics
        from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
        from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
        from seeme_tpu_torch.nn.init import perturb_parameters_
        from seeme_tpu_torch.ops import _build
        from seeme_tpu_torch.ops import denoiser_fused as dfu
        from seeme_tpu_torch.ops import pointnet_fused as pfu
    except ImportError as e:
        print(f"chip_smoke: the seeme_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__)))
    if os.path.dirname(pkg_dir) != here:
        print(f"chip_smoke: seeme_tpu_torch was imported from {pkg_dir}, not from beside "
              f"this script ({here})", file=sys.stderr)
        return 2
    # full float32 products and convolutions (cuDNN's default is TF32), as
    # the JAX package's tests pin `highest`
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card
    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    kind = torch.cuda.get_device_name(0)
    phase(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} "
          f"x{torch.cuda.device_count()} | allow_tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}", t)

    # ---- 2. build
    t = time.perf_counter()
    _build.load_library()
    for line in _build.build_log.splitlines():  # ptxas -v: each kernel, its registers, spills
        if any(k in line for k in ("entry function", "registers", "spill", "wgmma",
                                    "setmaxnreg")):
            print("    " + line.strip(), flush=True)
    phase(f"build: {_build.library_path().name} (nvcc {_build.build_seconds or 0.0:.1f} s)", t)

    # ---- set-up: seeded system and batch at full width
    t = time.perf_counter()
    cfg = SeeMeConfig()
    data = SyntheticEgoDataset(BATCH, cfg.motion_length, scene_points=cfg.scene_points, seed=SEED)
    smpl = synthetic_smpl(n_verts=6890, seed=SEED)

    def build_system(device, variant="loop"):
        s = SeeMeSystem(dataclasses.replace(cfg, fused_variant=variant), smpl, data.mean,
                        data.std, device=device, seed=SEED)
        perturb_parameters_(s, torch.Generator().manual_seed(SEED + 1))
        return s

    system = build_system(dev)
    batch = to_torch(data.batch(0, BATCH), dev)
    phase(f"set-up: SeeMeConfig() system ({sum(p.numel() for p in system.parameters())} "
          f"params), batch {BATCH}, {cfg.scene_points} scene points", t)

    # ---- 3. kernels against their plain versions
    kernels = []
    pw = pfu.pointnet_weights(system.proscene["scene_enc"])
    B, N, H = BATCH, cfg.scene_points, system.proscene["scene_enc"].hidden_dim
    points = batch["scene"].contiguous()
    t = time.perf_counter()
    in_args = (points, pw["wpos"], pw["bpos"], pw["w0"], pw["b0"], pw["w1"], pw["b1"], pw["ws"])
    in_split = tuple(pw[f"{n}.split"] for n in pfu.INPUT_SPLIT)
    print_pointnet_launch(pfu.launch_info(True, H), pfu.TILE[H])
    out_k, pool_k = pfu.fused_input_block(*in_args, split=in_split)
    out_p, pool_p = pfu.fused_input_block_plain(*in_args)
    torch.cuda.synchronize()
    scale = float(out_p.abs().max())
    err = max(compare("input block out", out_k, out_p, scale, POINTNET_RTOL),
              compare("input block pool", pool_k, pool_p, scale, POINTNET_RTOL))
    del out_k, pool_k
    ms = time_ms(lambda: pfu.fused_input_block(*in_args, split=in_split), 3)
    plain_ms = time_ms(lambda: pfu.fused_input_block_plain(*in_args), 3)
    flops = input_block_flops(B, N, H)
    nbytes = tensor_bytes(points, pw["wpos"], pw["bpos"], pw["b0"], pw["b1"], *in_split)
    nbytes += 4 * (B * N * H + B * H)
    kernels.append(dict(name="pointnet_input_block", route="cuda",
                        source="seeme_tpu_torch/csrc/pointnet.cu",
                        replaces="seeme_tpu/ops/pointnet_pallas.py:112",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops))
    phase(f"kernel pointnet_input_block (B={B}, N={N}, H={H}): {ms:.3f} ms, plain {plain_ms:.3f} ms"
          f", {pointnet_rates(flops, nbytes, ms)}", t)

    t = time.perf_counter()
    sp_args = (out_p, pool_p, *(pw[f"block_1.{n}"]
                                for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")))
    sp_split = tuple(pw[f"block_1.{n}.split"] for n in pfu.BLOCK_SPLIT)
    print_pointnet_launch(pfu.launch_info(False, H), pfu.TILE[H])
    out_k, pool_k = pfu.fused_split_block(*sp_args, split=sp_split)
    out_s, pool_s = pfu.fused_split_block_plain(*sp_args)
    torch.cuda.synchronize()
    scale = float(out_s.abs().max())
    err = max(compare("split block out", out_k, out_s, scale, POINTNET_RTOL),
              compare("split block pool", pool_k, pool_s, scale, POINTNET_RTOL))
    del out_k, pool_k, out_s, pool_s
    ms = time_ms(lambda: pfu.fused_split_block(*sp_args, split=sp_split), 3)
    plain_ms = time_ms(lambda: pfu.fused_split_block_plain(*sp_args), 3)
    flops = split_block_flops(B, N, H)
    # x, pooled, w0p, b0, b1, wsp (the wrapper's folds) and the split weights
    nbytes = tensor_bytes(*(sp_args[i] for i in (0, 1, 3, 4, 6, 8)), *sp_split)
    nbytes += 4 * (B * N * H + B * H)
    kernels.append(dict(name="pointnet_split_block", route="cuda",
                        source="seeme_tpu_torch/csrc/pointnet.cu",
                        replaces="seeme_tpu/ops/pointnet_pallas.py:56",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops))
    phase(f"kernel pointnet_split_block (B={B}, N={N}, H={H}): {ms:.3f} ms, plain {plain_ms:.3f} ms"
          f", {pointnet_rates(flops, nbytes, ms)}", t)
    del out_p, pool_p, sp_args, in_args, in_split, sp_split
    torch.cuda.empty_cache()

    t = time.perf_counter()
    cond = system.encode_conditioning(batch)
    zeroed = dict(batch, feats=torch.zeros_like(batch["feats"]),
                  transl=torch.zeros_like(batch["transl"]), scene=torch.zeros_like(points))
    cond_cfg = torch.cat([system.encode_conditioning(zeroed), cond]).contiguous()
    z0 = torch.randn(B, 1, cfg.latent_dim[-1], generator=torch.Generator().manual_seed(SEED + 2))
    z0 = z0.to(dev)
    sd, weights, _ = system.kernel_operands()
    steps = cfg.num_inference_timesteps
    # each entry's row in the kernels line comes from the guidance its path
    # runs (SeeMeConfig().guidance_scale, 1.0, on B condition rows); guidance
    # 2.5 on the [uncond; cond] rows is an extra check of both entries
    for name, fn, g, c in (("ddim_md_t1", dfu.ddim_fused, cfg.guidance_scale, cond),
                           (None, dfu.ddim_fused, 2.5, cond_cfg),
                           ("ddim_fused_grid", dfu.ddim_fused_grid, cfg.guidance_scale, cond),
                           (None, dfu.ddim_fused_grid, 2.5, cond_cfg)):
        args = (sd, c, z0, system.schedule, steps, cfg.num_layers, g)
        z_k = fn(*args, weights=weights)
        z_p = dfu.ddim_fused_plain(*args)
        torch.cuda.synchronize()
        label = f"{fn.__name__} guidance {g}"
        err = compare(label, z_k, z_p, float(z_p.abs().max()), DDIM_RTOL)
        print_launch(dfu.cluster_launch(True, B, c.shape[1], weights, g))
        ms = time_ms(lambda: fn(*args, weights=weights), 3)
        plain_ms = time_ms(lambda: dfu.ddim_fused_plain(*args), 2)
        flops = ddim_flops(sd, cfg.num_layers, c.shape[0], c.shape[1], steps)
        nbytes = 4 * (sum(v.numel() for v in sd.values()) + c.numel() + 2 * z0.numel() + 2 * steps)
        phase(f"kernel ddim_md_t1 via {label} (B={B}, {steps} steps): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms(flops, nbytes):.4f} ms (f32 "
              f"{bound_f32_ms(flops, nbytes):.4f} ms)", t)
        t = time.perf_counter()
        if name:
            kernels.append(dict(name=name, route="cuda",
                                source="seeme_tpu_torch/csrc/ddim_md_t1.cu",
                                replaces="seeme_tpu/ops/denoiser_fused.py:"
                                + ("597" if name == "ddim_md_t1" else "757"),
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                flops=flops))

    # one request's latency: batch 1 at the path's guidance
    t = time.perf_counter()
    args = (sd, cond[:1].contiguous(), z0[:1].contiguous(), system.schedule, steps,
            cfg.num_layers, cfg.guidance_scale)
    z_p = dfu.ddim_fused_plain(*args)
    compare("ddim_fused B=1", dfu.ddim_fused(*args, weights=weights), z_p,
            float(z_p.abs().max()), DDIM_RTOL)
    print_launch(dfu.cluster_launch(True, 1, cond.shape[1], weights, cfg.guidance_scale))
    ms = time_ms(lambda: dfu.ddim_fused(*args, weights=weights), 3)
    flops = ddim_flops(sd, cfg.num_layers, 1, cond.shape[1], steps)
    nbytes = 4 * (sum(v.numel() for v in sd.values()) + args[1].numel() + 2 * args[2].numel()
                  + 2 * steps)
    phase(f"kernel ddim_md_t1 at B=1, guidance {cfg.guidance_scale}: {ms:.3f} ms, bound "
          f"{bound_ms(flops, nbytes):.4f} ms", t)

    # the T2M set-up comes after the EgoBody kernels' timings: allocated
    # before them, it moves where the EgoBody weights sit in device memory,
    # and that alone moved the MD DDIM kernel's time by 6-10% on an H100
    t2m_cfg = T2MConfig()
    t2m_data = SyntheticT2MDataset(BATCH, t2m_cfg.max_len, nfeats=t2m_cfg.nfeats, seed=SEED,
                                   text_dim=t2m_cfg.text_encoded_dim)

    def build_t2m(device):
        s = T2MSystem(t2m_cfg, t2m_data.mean, t2m_data.std, device=device, seed=SEED)
        perturb_parameters_(s, torch.Generator().manual_seed(SEED + 5))
        return s

    t2m = build_t2m(dev)
    t2m_batch = to_torch(t2m_data.batch(0, BATCH), dev)
    phase(f"set-up: T2MConfig() system ({sum(p.numel() for p in t2m.parameters())} params), "
          f"batch {BATCH}", t)
    t = time.perf_counter()
    t2m_sd, t2m_weights = t2m.kernel_operands()
    text = t2m_batch["text_emb"][:, None, :].contiguous()
    z0 = torch.randn(B, 1, t2m_cfg.latent_dim[-1],
                     generator=torch.Generator().manual_seed(SEED + 6)).to(dev)
    steps = t2m_cfg.num_inference_timesteps
    for g, c in ((1.0, text), (t2m_cfg.guidance_scale, torch.cat([torch.zeros_like(text), text]))):
        args = (t2m_sd, c.contiguous(), z0, t2m.schedule, steps, t2m_cfg.num_layers, g)
        z_k = dfu.ddim_fused_tok(*args, weights=t2m_weights)
        z_p = dfu.ddim_fused_plain(*args, md_trans=False)
        torch.cuda.synchronize()
        err = compare(f"ddim_tok guidance {g}", z_k, z_p, float(z_p.abs().max()), DDIM_RTOL)
        print_launch(dfu.cluster_launch(False, B, c.shape[1], t2m_weights, g))
        ms = time_ms(lambda: dfu.ddim_fused_tok(*args, weights=t2m_weights), 3)
        plain_ms = time_ms(lambda: dfu.ddim_fused_plain(*args, md_trans=False), 2)
        flops = tok_flops(t2m_sd, t2m_cfg.num_layers, c.shape[0], c.shape[1], steps)
        nbytes = 4 * (sum(v.numel() for v in t2m_sd.values()) + c.numel() + 2 * z0.numel()
                      + 2 * steps)
        phase(f"kernel ddim_tok_t1 (B={B}, guidance {g}, {steps} steps): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms(flops, nbytes):.4f} ms", t)
        t = time.perf_counter()
        if g == t2m_cfg.guidance_scale:  # the T2M path's guidance
            kernels.append(dict(name="ddim_tok_t1", route="cuda",
                                source="seeme_tpu_torch/csrc/ddim_tok_t1.cu",
                                replaces="seeme_tpu/ops/denoiser_fused.py:597",
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                flops=flops))
    # one request's latency: batch 1 ([uncond; cond] rows of sample 0) at the path's guidance
    g = t2m_cfg.guidance_scale
    args = (t2m_sd, torch.cat([torch.zeros_like(text[:1]), text[:1]]).contiguous(),
            z0[:1].contiguous(), t2m.schedule, steps, t2m_cfg.num_layers, g)
    z_p = dfu.ddim_fused_plain(*args, md_trans=False)
    compare("ddim_tok B=1", dfu.ddim_fused_tok(*args, weights=t2m_weights), z_p,
            float(z_p.abs().max()), DDIM_RTOL)
    print_launch(dfu.cluster_launch(False, 1, text.shape[1], t2m_weights, g))
    ms = time_ms(lambda: dfu.ddim_fused_tok(*args, weights=t2m_weights), 3)
    flops = tok_flops(t2m_sd, t2m_cfg.num_layers, 2, text.shape[1], steps)
    nbytes = 4 * (sum(v.numel() for v in t2m_sd.values()) + args[1].numel()
                  + 2 * args[2].numel() + 2 * steps)
    phase(f"kernel ddim_tok_t1 at B=1, guidance {g}: {ms:.3f} ms, bound "
          f"{bound_ms(flops, nbytes):.4f} ms", t)
    del z_k, z_p

    counters = counter_table(pfu, dfu)

    def counted(run):
        """Run with every launch count set to 0 just before; return the
        result and the counts read just after."""
        zero_counters(counters, pfu)
        out = run()
        torch.cuda.synchronize()
        return out, read_counters(counters, pfu, dfu)

    launches = {}
    by_path = {name: {} for name in counters}  # every kernel's launches on every path

    def record(path, counts):
        for name in by_path:
            by_path[name][path] = counts[name]

    # ---- 4. the EgoBody slice, counted
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def ego_slice():
        feats = system.sample_from_cond(system.encode_conditioning(batch), generator=gen)
        out = system.eval_fk(batch, feats)
        mask = torch.ones(B, cfg.motion_length, dtype=torch.bool, device=dev)
        return feats, out, ego_sequence_metrics(out["joints_rst"], out["joints_ref"],
                                                out["quat_rst"], out["quat_ref"], mask)

    (feats, out, per_seq), counts = counted(ego_slice)
    slice_s = time.perf_counter() - t
    require(tuple(feats.shape) == (B, cfg.motion_length, cfg.nfeats), f"features {feats.shape}")
    require(tuple(out["joints_rst"].shape) == (B, cfg.motion_length, 24, 3), "joints shape")
    for k, v in {**out, **per_seq}.items():
        require(bool(torch.isfinite(v).all()), f"{k} not finite")
    expected = {**{k: 0 for k in counters}, "pointnet_input_block": 1, "pointnet_split_block": 3,
                "ddim_md_t1": 1}
    require(counts == expected, f"launch counts {counts}")
    for k in ("pointnet_input_block", "pointnet_split_block", "ddim_md_t1"):
        launches[k] = counts[k]
    record("egobody_sampling", counts)
    means = {k: round(float(v.mean()), 4) for k, v in per_seq.items()}
    kept = filtered_means(per_seq)["kept"]
    phase(f"slice B={B}: features {tuple(feats.shape)}, launches {counts}, per-sequence "
          f"means {json.dumps(means)}, {kept}/{B} pass the test-split filter ({slice_s:.3f} s)", t)

    t = time.perf_counter()
    small = {k: v[:2].cpu() for k, v in batch.items()}
    small["scene"] = small["scene"][:, :512].contiguous()
    z_small = torch.randn(2, 1, cfg.latent_dim[-1], generator=torch.Generator().manual_seed(SEED + 4))
    cpu_system = build_system("cpu")
    ref = cpu_system.sample_from_cond(cpu_system.encode_conditioning(small), z_init=z_small)
    ref_out = cpu_system.eval_fk(small, ref)
    got = system.sample_from_cond(system.encode_conditioning({k: v.to(dev) for k, v in small.items()}),
                                  z_init=z_small.to(dev))
    got_out = system.eval_fk({k: v.to(dev) for k, v in small.items()}, got)
    compare("slice features, card vs CPU", got.cpu(), ref, float(ref.abs().max()), SLICE_RTOL)
    compare("slice joints, card vs CPU", got_out["joints_rst"].cpu(), ref_out["joints_rst"],
            float(ref_out["joints_rst"].abs().max()), SLICE_RTOL)
    del cpu_system
    phase("slice reference: card path agrees with the CPU plain path (B=2, 512 points)", t)

    t = time.perf_counter()
    grid_system = build_system(dev, "grid")
    cond = system.encode_conditioning(batch)
    z_init = torch.randn(B, 1, cfg.latent_dim[-1], generator=torch.Generator().manual_seed(SEED + 7))
    loop_feats = system.sample_from_cond(cond, z_init=z_init.to(dev))
    grid_feats, counts = counted(lambda: grid_system.sample_from_cond(cond, z_init=z_init.to(dev)))
    require(counts == {**{k: 0 for k in counters}, "ddim_fused_grid": 1},
            f"grid variant launch counts {counts}")
    launches["ddim_fused_grid"] = counts["ddim_fused_grid"]
    record("egobody_sampling_grid_variant", counts)
    compare("grid vs loop variant features", grid_feats, loop_feats,
            float(loop_feats.abs().max()), SLICE_RTOL)
    del grid_system
    phase(f"grid variant: sample_from_cond with fused_variant='grid', launches {counts}", t)

    # ---- 5. the T2M slice, counted
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    lengths = t2m_batch["length"].long()
    feats, counts = counted(lambda: t2m.sample(t2m_batch["text_emb"], lengths=lengths,
                                               generator=gen))
    joints = t2m.feats_to_joints(feats)
    joints_ref = t2m.feats_to_joints(t2m_batch["motion"])
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t
    mr = MRMetrics()
    mr.update(joints.cpu().numpy(), joints_ref.cpu().numpy(), lengths.cpu().numpy())
    mr_means = mr.compute()
    T, F = t2m_cfg.max_len, t2m_cfg.nfeats
    require(tuple(feats.shape) == (B, T, F), f"t2m features {tuple(feats.shape)}")
    require(tuple(joints.shape) == (B, T, 22, 3), f"t2m joints {tuple(joints.shape)}")
    require(bool(torch.isfinite(feats).all() and torch.isfinite(joints).all()),
            "t2m outputs not finite")
    require(all(math.isfinite(v) for v in mr_means.values()) and len(mr_means) == 3,
            f"MR metrics {mr_means}")
    require(counts == {**{k: 0 for k in counters}, "ddim_tok_t1": 1}, f"t2m launch counts {counts}")
    launches["ddim_tok_t1"] = counts["ddim_tok_t1"]
    record("t2m_sampling", counts)
    mr_text = json.dumps({k: round(float(v), 4) for k, v in mr_means.items()})
    phase(f"t2m slice B={B}: features {tuple(feats.shape)}, joints {tuple(joints.shape)}, "
          f"launches {counts}, MR means (mm) {mr_text} (sample + FK {sample_s:.3f} s)", t)

    t = time.perf_counter()
    cpu_t2m = build_t2m("cpu")
    text_small = t2m_batch["text_emb"][:2].cpu()
    len_small = lengths[:2].cpu()
    z_small = torch.randn(2, 1, t2m_cfg.latent_dim[-1],
                          generator=torch.Generator().manual_seed(SEED + 9))
    ref = cpu_t2m.sample(text_small, lengths=len_small, z_init=z_small)
    ref_joints = cpu_t2m.feats_to_joints(ref)
    got = t2m.sample(text_small.to(dev), lengths=len_small.to(dev), z_init=z_small.to(dev))
    got_joints = t2m.feats_to_joints(got)
    compare("t2m features, card vs CPU", got.cpu(), ref, float(ref.abs().max()), SLICE_RTOL)
    scale = float(ref_joints.abs().max())
    compare("t2m joints, card vs CPU", got_joints.cpu(), ref_joints, scale, SLICE_RTOL)
    # where the joints' gap comes from: the RIC recovery itself on the card
    # (the CPU's features through feats_to_joints on both devices), and the
    # features' own gap carried through the CPU's recovery
    fk_gap = float((t2m.feats_to_joints(ref.to(dev)).cpu() - ref_joints).abs().max())
    carried = float((cpu_t2m.feats_to_joints(got.cpu()) - ref_joints).abs().max())
    print(f"    t2m joints gap split: RIC recovery card vs CPU on the same features "
          f"{fk_gap / scale:.3e}, the features' gap through the CPU recovery "
          f"{carried / scale:.3e} (relative to {scale:.4g})", flush=True)
    phase("t2m reference: card path agrees with the CPU plain path (B=2)", t)

    del system, t2m, cpu_t2m, t2m_batch, batch
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="seeme_train_")
    try:
        s1_checkpoint = train_phases(dev, counted, counters, record, work)
        by_cond = variant_phases(dev, counted, counters, record, s1_checkpoint, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    hmr_phases(dev, counted, counters, record, kernels, launches)
    work = tempfile.mkdtemp(prefix="seeme_t2m_")
    try:
        t2m_phases(dev, counted, counters, record, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    work = tempfile.mkdtemp(prefix="seeme_hmr_train_")
    try:
        hmr_train_phases(dev, counted, counters, record, kernels, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    work = tempfile.mkdtemp(prefix="seeme_a2m_")
    try:
        a2m_phases(dev, counted, counters, record, kernels, launches, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    work = tempfile.mkdtemp(prefix="seeme_multitoken_")
    try:
        multitoken_phases(dev, counted, counters, record, kernels, launches, work)
        mld_phases(dev, counted, counters, record, kernels, launches)
        entry_phases(dev, counted, counters, record, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="seeme_tools_")
    try:
        smpl_file_phases(dev, counted, counters, record, work)
        evaluator_phases(dev, counted, counters, record, work)
        feature_phases(dev)
        prefetch_phases(dev, counted, counters, record, work)
        slice13_phases(dev, counted, counters, record, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="seeme_dispatch_")
    try:
        dispatch_phases(dev, counted, counters, record, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="seeme_ddp_")
    try:
        ddp_phases(dev, record, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="seeme_slice16_")
    try:
        slice16_phases(dev, counted, counters, record, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for k in kernels:
        flops, nbytes = k.pop("flops"), k.pop("bytes")
        k["launches"] = launches[k["name"]]
        # beside its main path's count (a row at another shape reads its wrapper's)
        k["launches_by_path"] = by_path[k.pop("counter", k["name"])]
        if k["name"] == "ddim_md_t1":  # at the condition-token counts of the other configs
            k["at_n_cond"] = by_cond
        k["bound_ms"] = bound_ms(flops, nbytes)
        k["bound_by"] = bound_by(flops, nbytes)
        k["bound_f32_ms"] = bound_f32_ms(flops, nbytes)  # comparable with earlier f32-FMA rows
        if k["name"].startswith("pointnet"):
            k["floor_ms"] = floor_ms(flops, nbytes)
            k["tflops"] = flops / k["ms"] / 1e9
        k["library_ms"] = None  # no single PyTorch call computes any of these functions
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi --query-gpu=name,power.limit --format=csv,noheader gives it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def train_phases(dev, counted, counters, record, work: str) -> str:
    """Phases 6-10: the EgoBody main path's two training stages on the card,
    in `work`. Records each kernel's launches in each training phase;
    returns the stage-1 checkpoint."""
    import torch

    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.data.batch import eval_batches
    from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
    from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.train.__main__ import Trainer, main, parse_args
    from seeme_tpu_torch.train.loop import train_step, validate
    from seeme_tpu_torch.train.state import make_optimizer, set_stage

    none = {k: 0 for k in counters}

    def step_summary(trainer):
        losses = [s["total"] for r in trainer.history for s in r["steps"]]
        ms = sorted(m for r in trainer.history for m in r["step_ms"][int(r is trainer.history[0]):])
        require(all(math.isfinite(v) for v in losses), f"losses not finite: {losses}")
        return losses, ms

    def fixed_eval_loss(trainer):
        """The val loss with dropout off and the validation's fixed draws."""
        set_stage(trainer.system, None)
        out = validate(trainer.system, trainer.stage,
                       eval_batches(trainer.datamodule, "val", trainer.batch_size))["total"]
        set_stage(trainer.system, trainer.stage)
        return out

    # ---- 6. stage 1
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    s1, counts = counted(lambda: main(["--preset", "vae_egobody", "--epochs", "2",
                                       "--out", os.path.join(work, "s1"), *HOST_ROUTE]))
    peak = torch.cuda.max_memory_allocated()
    require(counts == none, f"stage 1 launch counts {counts}")
    record("train_stage1", counts)
    losses, ms = step_summary(s1)
    first, last = s1.history[0]["means"]["total"], s1.history[-1]["means"]["total"]
    require(len(losses) == 8, f"stage 1 took {len(losses)} steps")
    require(last < first, f"stage 1 epoch losses {first} -> {last} did not fall")
    phase(f"train stage 1 (vae_egobody, B={s1.batch_size}): {len(losses)} steps, losses "
          f"{[round(v, 5) for v in losses]}, epoch means {first:.5f} -> {last:.5f}, "
          f"{ms[len(ms) // 2]:.3f} ms a step (median of {len(ms)}, min {ms[0]:.3f}, max "
          f"{ms[-1]:.3f}), peak memory {peak} B, launches {counts}", t)

    # ---- 7. stage 2: set-up, cache fill, epochs, validation
    t = time.perf_counter()
    argv = ["--preset", "mld_egobody", "--epochs", "2", "--out", os.path.join(work, "s2"),
            "--pretrained_vae", s1.checkpoints[-1], "train.val_every_steps=2", *HOST_ROUTE]
    s2 = Trainer(parse_args(argv))
    sd1 = s1.system.state_dict()
    loaded = {k: v.clone() for k, v in s2.system.state_dict().items()}
    require(all(torch.equal(loaded[k], v) for k, v in sd1.items() if k.startswith("vae.")),
            "stage 2 did not load the stage-1 VAE")
    s2.system.kernel_operands()  # DDIM copies of the untrained denoiser, to be outdated
    torch.cuda.reset_peak_memory_stats()
    fill_s, counts = counted(s2.fill_feature_cache)
    expected = {**none, "pointnet_input_block": 5, "pointnet_split_block": 15}
    require(counts == expected, f"cache fill launch counts {counts}")
    record("train_stage2_cache_fill", counts)
    val_before = fixed_eval_loss(s2)
    _, counts = counted(s2.fit)
    peak = torch.cuda.max_memory_allocated()
    require(counts == none, f"stage 2 epochs launch counts {counts}")
    record("train_stage2_cached_steps", counts)
    losses, ms = step_summary(s2)
    require(len(losses) == 8 and "val" in s2.history[-1], "stage 2 steps or validation")
    val_after = fixed_eval_loss(s2)
    require(val_after < val_before, f"stage 2 fixed-draw val loss {val_before} -> {val_after}")
    after = s2.system.state_dict()
    for k, v in after.items():
        if k.startswith(("vae.", "proscene.")):
            require(torch.equal(v, loaded[k]), f"frozen {k} changed")
        elif k.startswith("output_scene.1."):
            require(not torch.equal(v, loaded[k]), f"trainable {k} did not change")
    require(any(not torch.equal(v, loaded[k]) for k, v in after.items()
                if k.startswith("denoiser.")), "the denoiser did not change")
    first, last = s2.history[0]["means"]["total"], s2.history[-1]["means"]["total"]
    phase(f"train stage 2 (mld_egobody, B={s2.batch_size}): cache fill {fill_s:.3f} s, "
          f"launches {expected}; {len(losses)} steps, losses {[round(v, 5) for v in losses]}, "
          f"epoch means {first:.5f} -> {last:.5f}, val {s2.history[-1]['val']['total']:.5f}, "
          f"fixed-draw val {val_before:.5f} -> {val_after:.5f}, {ms[len(ms) // 2]:.3f} ms a "
          f"step (median of {len(ms)}, min {ms[0]:.3f}, max {ms[-1]:.3f}), peak memory "
          f"{peak} B", t)

    t = time.perf_counter()
    for name, trainer in (("stage 1", s1), ("stage 2", s2)):
        busy, wall, events = device_busy(trainer, 3)
        print(f"    {name}: device busy {busy:.3f} of {wall:.3f} ms over 3 more steps "
              f"(torch.profiler on, {events} device kernels and copies): idle share "
              f"{1 - busy / wall:.3f}", flush=True)
    phase("training steps' device idle share (extra steps after the checks, not counted)", t)

    t = time.perf_counter()
    kernel_ms = profile_fill(s2)
    phase(f"cache fill, PointNet kernels' device time (torch.profiler, second fill): "
          f"{json.dumps(kernel_ms)}", t)

    # ---- 8. CFG training at guidance 2.5 (no cache)
    t = time.perf_counter()
    cfg_run = Trainer(parse_args(["--preset", "mld_egobody", "--out",
                                  os.path.join(work, "s2_cfg"), "--pretrained_vae",
                                  s1.checkpoints[-1], "model.guidance_scale=2.5",
                                  *HOST_ROUTE]))
    require(cfg_run.fill_feature_cache() is None, "the cache filled at guidance 2.5")
    batches = cfg_run.train_batches(0)
    for i in range(2):
        b = to_torch(next(batches), dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        terms, counts = counted(lambda: train_step(
            cfg_run.system, "diffusion", cfg_run.optimizer, cfg_run.schedule, i, b,
            cfg_run.generator))
        end.record()
        end.synchronize()
        require(counts == {**none, "pointnet_input_block": 1, "pointnet_split_block": 3},
                f"guidance 2.5 step launch counts {counts}")
        require(math.isfinite(terms["total"]), f"guidance 2.5 loss {terms}")
        phase(f"train stage 2 at guidance 2.5, step {i}: loss {terms['total']:.5f}, "
              f"{start.elapsed_time(end):.3f} ms, launches {counts}", t)
        t = time.perf_counter()
    record("train_stage2_cfg_step", counts)
    del cfg_run, batches, b

    # ---- 9. sampling on the trained weights
    t = time.perf_counter()
    system = s2.system
    set_stage(system, None)
    vb = to_torch(next(s2.datamodule.batches("val", s2.batch_size, shuffle=False)), dev)
    cond = system.encode_conditioning(vb)
    z0 = torch.randn(cond.shape[0], 1, system.cfg.latent_dim[-1],
                     generator=torch.Generator().manual_seed(SEED + 11)).to(dev)
    feats, counts = counted(lambda: system.sample_from_cond(cond, z_init=z0))
    require(counts == {**none, "ddim_md_t1": 1}, f"sampling launch counts {counts}")
    record("sample_after_training", counts)
    sd, weights, _ = system.kernel_operands()
    args = (sd, cond, z0, system.schedule, system.cfg.num_inference_timesteps,
            system.cfg.num_layers, system.cfg.guidance_scale)
    z_p = dfu.ddim_fused_plain(*args)
    compare("ddim_fused on the trained weights", dfu.ddim_fused(*args, weights=weights), z_p,
            float(z_p.abs().max()), DDIM_RTOL)
    plain_feats = system.vae.decode(z_p, system.cfg.motion_length)
    compare("sampled features on the trained weights", feats, plain_feats,
            float(plain_feats.abs().max()), SLICE_RTOL)
    stage1_through_kernel5(s1.system, vb, counted, none, record, "egobody_stage1_sampling_t1")
    phase(f"sampling after training (B={cond.shape[0]}): launches {counts}; the stage-1 model "
          f"(md_trans False) through kernel 5 once, within {DDIM_RTOL:.0e} of the plain version",
          t)
    s1_checkpoint = s1.checkpoints[-1]
    del s1, s2, system
    torch.cuda.empty_cache()

    # ---- 10. one step of each stage, card vs CPU
    t = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"    torch.backends.cuda.matmul.allow_tf32={flags[0]}, "
          f"torch.backends.cudnn.allow_tf32={flags[1]}", flush=True)
    require(flags == (False, False), "TF32 is on; the card-vs-CPU step needs f32 products")
    small = dict(latent_dim=(1, 32), ff_size=16, num_layers=3, scene_points=64,
                 scene_feat_dim=32, dropout=0.0)
    for stage, condition in (("vae", ()), ("diffusion", ("interactee", "scene"))):
        data = SyntheticEgoDataset(3, 60, scene_points=64, with_scene=bool(condition),
                                   seed=SEED)
        runs = {}
        for device in ("cpu", dev):
            s = SeeMeSystem(SeeMeConfig(condition=condition, **small),
                            synthetic_smpl(256, seed=SEED), data.mean, data.std,
                            device=device, seed=SEED)
            perturb_parameters_(s, torch.Generator().manual_seed(SEED + 12))
            runs[str(device)] = (s, *make_optimizer(stage, s, lr=TRAIN_LR))
        cpu_batch = to_torch(data.batch(0, 3), "cpu")
        draws = runs["cpu"][0].loss_draws(stage, cpu_batch,
                                          torch.Generator().manual_seed(SEED + 13))
        out = {}
        for device, (s, opt, sched) in runs.items():
            on = {k: v.to(device) for k, v in cpu_batch.items()}
            terms = train_step(s, stage, opt, sched, 0, on,
                               draws={k: v.to(device) for k, v in draws.items()})
            out[device] = terms["total"]
        compare_step(stage, runs["cpu"][0], runs[str(dev)][0], out["cpu"], out[str(dev)],
                     TRAIN_LR)
    phase("card vs CPU: one step of each stage at the small size agrees", t)
    return s1_checkpoint


def variant_phases(dev, counted, counters, record, s1_checkpoint: str, work: str) -> dict:
    """Phases 11-15: the image-conditioned SEE-ME, GIMO and the
    interactee-only config at full width (B=64), stage 2 of the image config,
    and the test CLI. Records each kernel's launches on each path; returns
    kernel 3's numbers at 3 and 1 condition tokens."""
    import torch

    from seeme_tpu_torch.config.egobody import PRESETS
    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
    from seeme_tpu_torch.eval.metrics import EgoMetric
    from seeme_tpu_torch.models.seeme import SeeMeSystem
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.test.__main__ import Evaluator
    from seeme_tpu_torch.test.__main__ import parse_args as test_args
    from seeme_tpu_torch.train.__main__ import Trainer
    from seeme_tpu_torch.train.__main__ import parse_args as train_args

    none = {k: 0 for k in counters}
    smpl = synthetic_smpl(n_verts=6890, seed=SEED)
    by_cond = {}

    def build(cfg, data, device):
        s = SeeMeSystem(cfg, smpl, data.mean, data.std, device=device, seed=SEED)
        perturb_parameters_(s, torch.Generator().manual_seed(SEED + 21))
        if s.use_image:
            randomize_batch_stats_(s.image_encoder, torch.Generator().manual_seed(SEED + 22))
        return s

    def dataset(cfg, n, points, image_size, seed):
        return SyntheticEgoDataset(n, cfg.motion_length, pose_feats=cfg.pose_feats,
                                   scene_points=points, with_scene="scene" in cfg.condition,
                                   with_image="image" in cfg.condition, image_size=image_size,
                                   seed=seed)

    def ego_slice(system, batch, gen):
        feats = system.sample_from_cond(system.encode_conditioning(batch), generator=gen)
        out = system.eval_fk(batch, feats)
        metric = EgoMetric(split="val")  # every sequence counts: no filter to empty a small batch
        mask = torch.ones(feats.shape[:2], dtype=torch.bool, device=feats.device)
        metric.update(out["joints_rst"], out["joints_ref"], out["quat_rst"], out["quat_ref"], mask)
        return feats, out, metric.compute()

    def card_vs_cpu(label, cfg, points, image_size):
        """The card path against the CPU's plain path on a small input (B=2)."""
        data = dataset(cfg, 2, points, image_size, SEED + 23)
        card, cpu = build(cfg, data, dev), build(cfg, data, "cpu")
        small = to_torch(data.batch(0, 2), "cpu")
        z = torch.randn(2, 1, cfg.latent_dim[-1], generator=torch.Generator().manual_seed(SEED + 24))
        results = []
        for s, d in ((cpu, "cpu"), (card, dev)):
            b = {k: v.to(d) for k, v in small.items()}
            feats = s.sample_from_cond(s.encode_conditioning(b), z_init=z.to(d))
            out = s.eval_fk(b, feats)
            metric = EgoMetric(split="val")
            metric.update(out["joints_rst"], out["joints_ref"], out["quat_rst"], out["quat_ref"],
                          torch.ones(2, cfg.motion_length, dtype=torch.bool, device=d))
            results.append((feats.cpu(), out["joints_rst"].cpu(), metric.compute()))
        (f_ref, j_ref, m_ref), (f_got, j_got, m_got) = results
        compare(f"{label} features, card vs CPU", f_got, f_ref, float(f_ref.abs().max()), SLICE_RTOL)
        compare(f"{label} joints, card vs CPU", j_got, j_ref, float(j_ref.abs().max()), SLICE_RTOL)
        require(set(m_got) == set(m_ref) == {"MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR",
                                             "ACCL"}, f"{label} metric keys {sorted(m_got)}")
        for k in sorted(m_ref):
            compare(f"{label} {k}, card vs CPU", torch.tensor(m_got[k]), torch.tensor(m_ref[k]),
                    abs(m_ref[k]), SLICE_RTOL)

    def kernel_at(label, system, cond, guidance, z0):
        """Kernel 3 on these condition rows against its plain version: error,
        launch plan, ms, plain ms, bound."""
        sd, weights, _ = system.kernel_operands()
        cfg = system.cfg
        args = (sd, cond.contiguous(), z0, system.schedule, cfg.num_inference_timesteps,
                cfg.num_layers, guidance)
        z_k = dfu.ddim_fused(*args, weights=weights)
        z_p = dfu.ddim_fused_plain(*args)
        torch.cuda.synchronize()
        B, nc = z0.shape[0], cond.shape[1]
        err = compare(f"{label}: ddim_fused at NC={nc}, guidance {guidance}", z_k, z_p,
                      float(z_p.abs().max()), DDIM_RTOL)
        info = dfu.cluster_launch(True, B, nc, weights, guidance)
        print_launch(info)
        ms = time_ms(lambda: dfu.ddim_fused(*args, weights=weights), 3)
        plain_ms = time_ms(lambda: dfu.ddim_fused_plain(*args), 2)
        steps = cfg.num_inference_timesteps
        flops = ddim_flops(sd, cfg.num_layers, cond.shape[0], nc, steps)
        nbytes = 4 * (sum(v.numel() for v in sd.values()) + cond.numel() + 2 * z0.numel()
                      + 2 * steps)
        by_cond[f"n_cond={nc}, guidance={guidance}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(flops, nbytes),
            bound_by=bound_by(flops, nbytes), bound_f32_ms=bound_f32_ms(flops, nbytes),
            launch=info)
        return ms, plain_ms, bound_ms(flops, nbytes)

    # ---- 11. the image-conditioned SEE-ME at full width
    t = time.perf_counter()
    cfg = PRESETS["mld_egobody_image"]().model
    data = dataset(cfg, BATCH, cfg.scene_points, cfg.image_size, SEED)
    system = build(cfg, data, dev)
    batch = to_torch(data.batch(0, BATCH), dev)
    resnet_calls = forward_counter(system.image_encoder)
    phase(f"set-up: mld_egobody_image system ({sum(p.numel() for p in system.parameters())} "
          f"params), batch {BATCH}, {cfg.scene_points} points, {cfg.image_size}x{cfg.image_size} "
          f"crops", t)
    t = time.perf_counter()
    z0 = torch.randn(BATCH, 1, cfg.latent_dim[-1],
                     generator=torch.Generator().manual_seed(SEED + 25)).to(dev)
    cond = system.encode_conditioning(batch)
    zeroed = dict(batch, **{k: torch.zeros_like(batch[k]) for k in ("feats", "transl", "scene",
                                                                    "image")})
    cond_cfg = torch.cat([system.encode_conditioning(zeroed), cond])
    for g, c in ((cfg.guidance_scale, cond), (2.5, cond_cfg)):
        ms, plain_ms, bnd = kernel_at("image slice", system, c, g, z0)
        phase(f"kernel ddim_md_t1 at NC=3 (B={BATCH}, guidance {g}): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bnd:.4f} ms", t)
        t = time.perf_counter()
    resnet_ms = time_ms(lambda: system.image_features(batch["image"]), 3)
    phase(f"ResNet50 at B={BATCH}, {cfg.image_size}x{cfg.image_size}: {resnet_ms:.3f} ms "
          f"(CUDA events, TF32 off)", t)

    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    resnet_calls.clear()
    (feats, out, means), counts = counted(lambda: ego_slice(system, batch, gen))
    slice_s = time.perf_counter() - t
    expected = {**none, "pointnet_input_block": 1, "pointnet_split_block": 3, "ddim_md_t1": 1}
    require(counts == expected and len(resnet_calls) == 1,
            f"image slice launch counts {counts}, ResNet50 forwards {len(resnet_calls)}")
    record("image_sampling", counts)
    require(tuple(feats.shape) == (BATCH, cfg.motion_length, cfg.nfeats), f"features {feats.shape}")
    for k, v in out.items():
        require(bool(torch.isfinite(v).all()), f"image slice {k} not finite")
    require(all(math.isfinite(v) for v in means.values()), f"image slice metrics {means}")
    phase(f"image slice B={BATCH}: launches {counts}, ResNet50 forwards 1, EgoMetric (all "
          f"sequences) {json.dumps({k: round(v, 4) for k, v in means.items()})} "
          f"({slice_s:.3f} s)", t)

    # where the slice's time goes: each part timed with CUDA events on the same batch
    t = time.perf_counter()
    sd, weights, _ = system.kernel_operands()
    parts = {
        "pointnet": lambda: system.scene_features(batch["scene"]),
        "resnet50": lambda: system.image_features(batch["image"]),
        "interactee_encode_and_projections": lambda: system.encode_conditioning(cached),
        "ddim": lambda: dfu.ddim_fused(sd, cond, z0, system.schedule, cfg.num_inference_timesteps,
                                       cfg.num_layers, cfg.guidance_scale, weights=weights),
        "decode": lambda: system.vae.decode(z0, cfg.motion_length),
        "fk": lambda: system.eval_fk(batch, feats),
    }
    cached = {k: v for k, v in batch.items() if k not in ("scene", "image")}
    cached["scene_feats"] = system.scene_features(batch["scene"])
    cached["image_feats"] = system.image_features(batch["image"])
    split_ms = {name: time_ms(fn, 3) for name, fn in parts.items()}
    phase(f"image slice time split (ms, CUDA events, each part alone): "
          f"{json.dumps({k: round(v, 3) for k, v in split_ms.items()})}", t)
    del system, batch, cond, cond_cfg, cached, feats, out
    torch.cuda.empty_cache()

    t = time.perf_counter()
    card_vs_cpu("image slice", dataclasses.replace(cfg, scene_points=512, image_size=64), 512, 64)
    phase("image slice reference: card path agrees with the CPU plain path (B=2, 512 points, "
          "64x64 crops)", t)

    # ---- 12. GIMO and the interactee-only config at full width
    for name, nc in (("mld_gimo", 2), ("mld_interactee", 1)):
        t = time.perf_counter()
        cfg = PRESETS[name]().model
        data = dataset(cfg, BATCH, cfg.scene_points, cfg.image_size, SEED + 27)
        system = build(cfg, data, dev)
        batch = to_torch(data.batch(0, BATCH), dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 28)
        (feats, out, means), counts = counted(lambda: ego_slice(system, batch, gen))
        wall = time.perf_counter() - t
        scene = int(system.use_scene)
        expected = {**none, "pointnet_input_block": scene, "pointnet_split_block": 3 * scene,
                    "ddim_md_t1": 1}
        require(counts == expected, f"{name} launch counts {counts}")
        record(f"{name}_sampling", counts)
        require(tuple(feats.shape) == (BATCH, cfg.motion_length, cfg.nfeats), f"{name} features")
        for k, v in out.items():
            require(bool(torch.isfinite(v).all()), f"{name} {k} not finite")
        require(all(math.isfinite(v) for v in means.values()), f"{name} metrics {means}")
        phase(f"{name} B={BATCH} ({cfg.nfeats} features, NC={nc}): launches {counts}, EgoMetric "
              f"(all sequences) {json.dumps({k: round(v, 4) for k, v in means.items()})} "
              f"({wall:.3f} s with set-up)", t)
        if nc == 1:
            t = time.perf_counter()
            z0 = torch.randn(BATCH, 1, cfg.latent_dim[-1],
                             generator=torch.Generator().manual_seed(SEED + 29)).to(dev)
            ms, plain_ms, bnd = kernel_at(name, system, system.encode_conditioning(batch),
                                          cfg.guidance_scale, z0)
            phase(f"kernel ddim_md_t1 at NC=1 (B={BATCH}, guidance {cfg.guidance_scale}): "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd:.4f} ms", t)
        del system, batch, feats, out
        torch.cuda.empty_cache()
        t = time.perf_counter()
        card_vs_cpu(name, dataclasses.replace(cfg, scene_points=512), 512, cfg.image_size)
        phase(f"{name} reference: card path agrees with the CPU plain path (B=2, 512 points)", t)

    # ---- 13-14. stage 2 of the image config: the feature cache, cached steps
    t = time.perf_counter()
    trainer = Trainer(train_args(["--preset", "mld_egobody_image", "--epochs", "1",
                                  "--out", os.path.join(work, "s2_image"), "--pretrained_vae",
                                  s1_checkpoint, "train.val_every_steps=1", *HOST_ROUTE]))
    system = trainer.system
    frozen = {k: v.clone() for k, v in system.state_dict().items()
              if k.startswith(("image_encoder.", "vae.", "proscene."))}
    projection = system.output_images[1].weight.detach().clone()
    resnet_calls = forward_counter(system.image_encoder)
    resnet_events = []
    timed_image_features(system, resnet_events)
    phase(f"set-up: mld_egobody_image trainer (B={trainer.batch_size}, "
          f"{trainer.steps_per_epoch} steps an epoch)", t)
    t = time.perf_counter()
    fill_s, counts = counted(trainer.fill_feature_cache)
    resnet_ms = sum(a.elapsed_time(b) for a, b in resnet_events)
    expected = {**none, "pointnet_input_block": 5, "pointnet_split_block": 15}
    require(counts == expected and len(resnet_calls) == 5,
            f"image cache fill launch counts {counts}, ResNet50 forwards {len(resnet_calls)}")
    record("train_image_cache_fill", counts)
    require(trainer.datamodule.train_set.extras["image_feats"].shape == (256, 2048),
            "image_feats cache shape")
    phase(f"image cache fill: {fill_s:.3f} s, launches {counts}, ResNet50 forwards "
          f"{len(resnet_calls)} taking {resnet_ms:.3f} ms of device time (CUDA events around "
          f"each)", t)
    t = time.perf_counter()
    resnet_calls.clear()
    _, counts = counted(trainer.fit)
    require(counts == none and not resnet_calls,
            f"cached image steps launch counts {counts}, ResNet50 forwards {len(resnet_calls)}")
    record("train_image_cached_steps", counts)
    steps = [st["total"] for r in trainer.history for st in r["steps"]]
    ms = sorted(m for r in trainer.history for m in r["step_ms"][1:])
    require(all(math.isfinite(v) for v in steps) and "val" in trainer.history[-1],
            f"image stage 2 losses {steps}")
    grad = system.output_images[1].weight.grad
    require(grad is not None and float(grad.abs().max()) > 0, "output_images has no gradient")
    require(not torch.equal(system.output_images[1].weight, projection),
            "output_images did not train")
    after = system.state_dict()
    for k, v in frozen.items():
        require(torch.equal(after[k], v), f"frozen {k} changed")
    phase(f"image stage 2: {len(steps)} cached steps, losses {[round(v, 5) for v in steps]}, "
          f"{ms[len(ms) // 2]:.3f} ms a step (median of {len(ms)}), val "
          f"{trainer.history[-1]['val']['total']:.5f}, launches {counts}, ResNet50 forwards 0, "
          f"output_images max |g| {float(grad.abs().max()):.3e}, image_encoder, vae and "
          f"proscene bitwise unchanged", t)
    checkpoint = trainer.checkpoints[-1]
    del trainer, system, frozen, after
    torch.cuda.empty_cache()

    # ---- 15. the test CLI on the trained image config, 2 replications
    t = time.perf_counter()
    evaluator = Evaluator(test_args(["--preset", "mld_egobody_image", "--replication_times", "2",
                                     "--checkpoint", checkpoint, "--out",
                                     os.path.join(work, "test_image")]))
    resnet_calls = forward_counter(evaluator.system.image_encoder)
    result, counts = counted(evaluator.run)
    expected = {**none, "pointnet_input_block": 1, "pointnet_split_block": 3, "ddim_md_t1": 2}
    require(counts == expected and len(resnet_calls) == 1,
            f"test CLI launch counts {counts}, ResNet50 forwards {len(resnet_calls)} (one batch "
            f"of 64, two replications)")
    record("test_cli_2_replications", counts)
    with open(result["metrics_path"]) as f:
        stats = json.load(f)
    require(set(stats) == {"MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR", "ACCL"}
            and all(set(v) == {"mean", "conf_interval", "min", "max"}
                    and all(math.isfinite(x) for x in v.values()) for v in stats.values()),
            f"test CLI statistics {stats}")
    phase(f"test CLI (mld_egobody_image, 2 replications over the 64-sample test split): "
          f"launches {counts}, ResNet50 forwards 1, statistics "
          f"{json.dumps({k: {n: round(x, 4) for n, x in v.items()} for k, v in stats.items()})}",
          t)
    return by_cond


def hmr_phases(dev, counted, counters, record, kernels: list, launches: dict) -> None:
    """Phases 16-21: the perception stack's evaluation paths at full width
    (B = 64, 20 000 scene points, 224 x 224 crops, 6890 SMPL vertices): both
    PointNet kernels at hidden width 256 against their plain versions (their
    rows of the kernels line, launched by these paths), the ProHMR-Scene
    `forward_step` and the EgoHMR `sample` counted, timed part by part and
    held to the CPU's plain path on a small input, and both CLIs on one
    batch each."""
    import torch

    from seeme_tpu_torch import test_egohmr, test_prohmr_scene
    from seeme_tpu_torch.core.smpl import smpl_forward, synthetic_smpl
    from seeme_tpu_torch.data import egohmr_images as images
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.eval.hmr_metrics import HmrMetrics
    from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
    from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import pointnet_fused as pfu

    none = {k: 0 for k in counters}
    pointnet_256 = {**none, "pointnet_input_block_h256": 1, "pointnet_split_block_h256": 3}
    smpl = synthetic_smpl(n_verts=6890, seed=SEED)

    def egohmr_counts(cfg, steps):
        """One EgoHMR `sample`: the scene encode, then 2 x gcn_layers + 2
        GCN launches each step and for the final prediction."""
        return {**pointnet_256, "gcn_fused": (2 * cfg.gcn_layers + 2) * (steps + 1)}

    def build(cls, cfg, device, seed):
        m = cls(cfg, smpl, device=device, seed=SEED)
        perturb_parameters_(m, torch.Generator().manual_seed(seed))
        randomize_batch_stats_(m, torch.Generator().manual_seed(seed + 1))
        return m

    def small_pair(model, cls, cfg):
        """The model's weights on the CPU and a small input (B = 2, 512
        points, 224 x 224 crops) for the card-vs-CPU check."""
        cpu = cls(cfg, smpl, device="cpu", seed=SEED)
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        dm = images.EgoHmrImageDataModule(n_pts=512, img_size=224, smpl=smpl)
        return cpu, next(dm.batches("test", 2, shuffle=False))

    def mode_metrics(model, out_j, out_v, b, vis=None):
        """The CLIs' metrics of one prediction a sample."""
        gt_j, gt_v = test_prohmr_scene.ground_truth(model, b)
        metrics = HmrMetrics()
        metrics.update(out_j.cpu().numpy(), out_v.cpu().numpy(), gt_j.cpu().numpy(),
                       gt_v.cpu().numpy(), None if vis is None else vis.cpu().numpy())
        return metrics.compute()

    # ---- 16. set-up: the ProHMR-Scene model and a full-width batch
    t = time.perf_counter()
    p_cfg = ProHMRConfig()
    model = build(ProHMRScene, p_cfg, dev, SEED + 40)
    dm = images.EgoHmrImageDataModule(n_pts=HMR_POINTS, img_size=p_cfg.image_size, smpl=smpl)
    batch_np = next(dm.batches("train", BATCH, shuffle=False))
    batch = to_torch(batch_np, dev)
    require(tuple(batch["scene_pcd"].shape) == (BATCH, HMR_POINTS, 3)
            and tuple(batch["img"].shape) == (BATCH, 224, 224, 3), "ProHMR batch shapes")
    phase(f"set-up: ProHMRConfig() model ({sum(p.numel() for p in model.parameters())} params, "
          f"flow hidden {p_cfg.flow_hidden} x {p_cfg.flow_layers} layers x depth "
          f"{p_cfg.flow_depth}, context {p_cfg.total_context}), synthetic SMPL with "
          f"{smpl.v_template.shape[0]} vertices, batch {BATCH}, {HMR_POINTS} points, "
          f"224x224 crops", t)

    # ---- 17. kernels 1 and 2 at H = 256 against their plain versions
    w = pfu.pointnet_weights(model.scene_enc)
    H = model.scene_enc.hidden_dim
    require(H == 256, f"scene encoder width {H}")
    for input_block in (True, False):
        print_pointnet_launch(pfu.launch_info(input_block, H), pfu.TILE[H])
    in_names = ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")
    sp_names = ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")
    in_split = tuple(w[f"{n}.split"] for n in pfu.INPUT_SPLIT)
    sp_split = tuple(w[f"block_1.{n}.split"] for n in pfu.BLOCK_SPLIT)
    for b, n in ((BATCH, HMR_POINTS), (1, 1000), (3, 1077)):
        t = time.perf_counter()
        points = batch["scene_pcd"][:b, :n].contiguous()
        in_args = (points, *(w[k] for k in in_names))
        out_k, pool_k = pfu.fused_input_block(*in_args, split=in_split)
        out_p, pool_p = pfu.fused_input_block_plain(*in_args)
        torch.cuda.synchronize()
        scale = float(out_p.abs().max())
        err = max(compare(f"input block H=256 B={b} N={n} out", out_k, out_p, scale, POINTNET_RTOL),
                  compare(f"input block H=256 B={b} N={n} pool", pool_k, pool_p, scale,
                          POINTNET_RTOL))
        del out_k, pool_k
        iters = 3 if b == BATCH else 20
        ms = time_ms(lambda: pfu.fused_input_block(*in_args, split=in_split), iters)
        plain_ms = time_ms(lambda: pfu.fused_input_block_plain(*in_args), 3)
        flops = input_block_flops(b, n, H)
        nbytes = tensor_bytes(points, w["wpos"], w["bpos"], w["b0"], w["b1"], *in_split)
        nbytes += 4 * (b * n * H + b * H)
        phase(f"kernel pointnet_input_block (B={b}, N={n}, H={H}): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, {pointnet_rates(flops, nbytes, ms)}", t)
        if b == BATCH:
            kernels.append(dict(name="pointnet_input_block_h256", route="cuda",
                                source="seeme_tpu_torch/csrc/pointnet.cu",
                                replaces="seeme_tpu/ops/pointnet_pallas.py:112", hidden=H,
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                flops=flops))
        t = time.perf_counter()
        sp_args = (out_p, pool_p, *(w[f"block_1.{k}"] for k in sp_names))
        out_k, pool_k = pfu.fused_split_block(*sp_args, split=sp_split)
        out_s, pool_s = pfu.fused_split_block_plain(*sp_args)
        torch.cuda.synchronize()
        scale = float(out_s.abs().max())
        err = max(compare(f"split block H=256 B={b} N={n} out", out_k, out_s, scale, POINTNET_RTOL),
                  compare(f"split block H=256 B={b} N={n} pool", pool_k, pool_s, scale,
                          POINTNET_RTOL))
        del out_k, pool_k, out_s, pool_s
        ms = time_ms(lambda: pfu.fused_split_block(*sp_args, split=sp_split), iters)
        plain_ms = time_ms(lambda: pfu.fused_split_block_plain(*sp_args), 3)
        flops = split_block_flops(b, n, H)
        nbytes = tensor_bytes(*(sp_args[i] for i in (0, 1, 3, 4, 6, 8)), *sp_split)
        nbytes += 4 * (b * n * H + b * H)
        phase(f"kernel pointnet_split_block (B={b}, N={n}, H={H}): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, {pointnet_rates(flops, nbytes, ms)}", t)
        if b == BATCH:
            kernels.append(dict(name="pointnet_split_block_h256", route="cuda",
                                source="seeme_tpu_torch/csrc/pointnet.cu",
                                replaces="seeme_tpu/ops/pointnet_pallas.py:56", hidden=H,
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                flops=flops))
        del out_p, pool_p, sp_args, in_args
    torch.cuda.empty_cache()

    def check_outputs(label, out, shapes):
        for k, shape in shapes.items():
            require(tuple(out[k].shape) == shape, f"{label} {k} shape {tuple(out[k].shape)}")
        for k, v in out.items():
            if torch.is_tensor(v):
                require(bool(torch.isfinite(v.float()).all()), f"{label} {k} not finite")

    # ---- 18. the ProHMR-Scene evaluation slice, counted
    t = time.perf_counter()
    NS = p_cfg.num_test_samples
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)

    def prohmr_slice():
        out = model.forward_step(batch, generator=gen)
        return out, mode_metrics(model, out["pred_keypoints_3d"][:, 0, :24],
                                 out["pred_vertices"][:, 0], batch)

    (out, means), counts = counted(prohmr_slice)
    wall = time.perf_counter() - t
    require(counts == pointnet_256, f"ProHMR slice launch counts {counts}")
    record("prohmr_eval", counts)
    launches.update({k: counts[k] for k in ("pointnet_input_block_h256",
                                            "pointnet_split_block_h256")})
    check_outputs("ProHMR", out, {"pred_vertices": (BATCH, NS, 6890, 3),
                                  "pred_keypoints_3d": (BATCH, NS, 45, 3),
                                  "pred_keypoints_2d": (BATCH, NS, 45, 2),
                                  "log_prob": (BATCH, NS),
                                  "conditioning_feats": (BATCH, p_cfg.total_context)})
    require(set(means) == {"MPJPE", "PA-MPJPE", "V2V"}
            and all(math.isfinite(v) for v in means.values()), f"ProHMR metrics {means}")
    phase(f"ProHMR-Scene slice B={BATCH} (forward_step, {NS} samples, mode first; metrics on "
          f"the mode): launches {counts}, {json.dumps({k: round(v, 3) for k, v in means.items()})}"
          f" mm on random weights ({wall:.3f} s)", t)

    t = time.perf_counter()
    with torch.no_grad():
        ctx = model.conditioning_features(batch)
        z_mode = torch.zeros(BATCH, 1, p_cfg.flow_dim, device=dev)
        z_rnd = torch.randn(BATCH, NS - 1, p_cfg.flow_dim, generator=gen, device=dev)
        pose = model.flow_forward(ctx, z=torch.cat([z_mode, z_rnd], dim=1))
        parts = {
            "resnet50": lambda: model.encode_image(batch["img"]),
            "pointnet": lambda: model.encode_scene(batch["scene_pcd"]),
            "flow": lambda: (model.flow_forward(ctx, z=z_mode), model.flow_forward(ctx, z=z_rnd)),
            "smpl": lambda: smpl_forward(model.smpl, pose["betas"].reshape(-1, 10),
                                         pose["body_pose"].reshape(-1, 23, 3, 3),
                                         pose["global_orient"].reshape(-1, 1, 3, 3),
                                         pose2rot=False),
            "forward_step": lambda: model.forward_step(batch, generator=gen),
        }
        split_ms = {name: time_ms(fn, 3) for name, fn in parts.items()}
    phase(f"ProHMR-Scene time split (ms, CUDA events, each part alone; smpl over "
          f"{BATCH * NS} bodies): {json.dumps({k: round(v, 3) for k, v in split_ms.items()})}", t)

    t = time.perf_counter()
    cpu, small_np = small_pair(model, ProHMRScene, p_cfg)
    noise = torch.randn(2, NS - 1, p_cfg.flow_dim,
                        generator=torch.Generator().manual_seed(SEED + 44))
    ref = cpu.forward_step(to_torch(small_np, "cpu"), noise=noise)
    got = model.forward_step(to_torch(small_np, dev), noise=noise.to(dev))
    for k in ("pose_6d", "log_prob", "betas", "cam", "pred_keypoints_3d", "pred_vertices",
              "pred_cam_t_full", "pred_keypoints_2d_full", "conditioning_feats"):
        compare(f"ProHMR {k}, card vs CPU", got[k].cpu(), ref[k], float(ref[k].abs().max()),
                SLICE_RTOL)
    del cpu, model, out, ctx, pose
    torch.cuda.empty_cache()
    phase("ProHMR-Scene reference: card path agrees with the CPU plain path (B=2, 512 points, "
          "224x224 crops, 3 samples with shared base noise)", t)

    # ---- 19. the EgoHMR sampling slice, counted
    t = time.perf_counter()
    e_cfg = EgoHmrConfig()
    model = build(EgoHmr, e_cfg, dev, SEED + 45)
    S = model.sample_schedule.num_train_timesteps
    phase(f"set-up: EgoHmrConfig() model ({sum(p.numel() for p in model.parameters())} params, "
          f"GCN {e_cfg.gcn_hid_dim} x {e_cfg.gcn_layers} layers over {e_cfg.gcn_in_dim} inputs a "
          f"joint, {e_cfg.timestep_respacing}: {S} ancestral steps)", t)
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 46)

    def egohmr_slice():
        out = model.sample(batch, generator=gen)
        return out, mode_metrics(model, out["pred_keypoints_3d"][:, :24], out["pred_vertices"],
                                 batch, out["vis_mask_smpl"])

    (out, means), counts = counted(egohmr_slice)
    wall = time.perf_counter() - t
    require(counts == egohmr_counts(e_cfg, S), f"EgoHMR slice launch counts {counts}")
    record("egohmr_sampling", counts)
    launches["gcn_fused"] = counts["gcn_fused"]
    check_outputs("EgoHMR", out, {"pred_vertices": (BATCH, 6890, 3),
                                  "pred_keypoints_3d": (BATCH, 45, 3),
                                  "pred_x_start": (BATCH, 144), "vis_mask_smpl": (BATCH, 24)})
    require(set(means) == {"MPJPE", "PA-MPJPE", "V2V", "MPJPE-vis", "MPJPE-invis"}
            and all(math.isfinite(v) for v in means.values()), f"EgoHMR metrics {means}")
    phase(f"EgoHMR slice B={BATCH} (sample: {S} steps, each both predictions in one GCN call, "
          f"then forward at t=0): launches {counts}, "
          f"{json.dumps({k: round(v, 3) for k, v in means.items()})} mm on random weights "
          f"({wall:.3f} s)", t)

    t = time.perf_counter()
    with torch.no_grad():
        enc = model.encode(batch)
        vis = model.visibility_mask(batch)
        cond = model.conditioning(enc, vis)
        cond_un = model.mask_cond(cond)
        vis6 = vis.repeat_interleave(6, dim=-1)
        x0 = torch.randn(BATCH, 144, generator=gen, device=dev)

        def steps():
            x = x0
            for i in range(S - 1, -1, -1):
                mt = torch.full((BATCH,), int(model.timestep_map[i]), dtype=torch.long, device=dev)
                x = model.sample_schedule.ddpm_step(model._fused_x0(cond, cond_un, vis6, x, mt),
                                                    i, x, x0)
            return x

        final = model(batch, x0, torch.zeros(BATCH, dtype=torch.long, device=dev),
                      eval_with_uncond=True, enc=enc)
        rot = final["pred_smpl_params"]
        parts = {
            "resnet50": lambda: model.backbone(batch["img"]),
            "pointnet": lambda: model.encode_scene(batch["scene_pcd"]),
            f"eager_gcn_{S}_steps": steps,
            "smpl": lambda: smpl_forward(model.smpl, rot["betas"], rot["body_pose"],
                                         rot["global_orient"], pose2rot=False),
            "sample": lambda: model.sample(batch, generator=gen),
        }
        split_ms = {name: time_ms(fn, 2) for name, fn in parts.items()}
    phase(f"EgoHMR time split (ms, CUDA events, each part alone): "
          f"{json.dumps({k: round(v, 3) for k, v in split_ms.items()})}", t)

    # ---- 66. the GCN kernels at the model's widths, on this batch
    t = time.perf_counter()
    with torch.no_grad():
        kernels.append(gcn_phase(dev, model, enc, vis, x0, gen))
    phase("GCN kernels against the plain path on the card, timed (the kernels line's "
          "`gcn_fused` row)", t)

    t = time.perf_counter()
    cpu, small_np = small_pair(model, EgoHmr, e_cfg)
    g = torch.Generator().manual_seed(SEED + 48)
    x_init, noise = torch.randn(2, 144, generator=g), torch.randn(S, 2, 144, generator=g)
    ref = cpu.sample(to_torch(small_np, "cpu"), x_init=x_init, noise=noise)
    got = model.sample(to_torch(small_np, dev), x_init=x_init.to(dev),
                       noise=noise.to(dev))
    require(torch.equal(got["vis_mask_smpl"].cpu(), ref["vis_mask_smpl"]), "EgoHMR vis mask")
    for k in ("pred_x_start", "pred_keypoints_3d", "pred_vertices"):
        compare(f"EgoHMR {k}, card vs CPU", got[k].cpu(), ref[k], float(ref[k].abs().max()),
                SLICE_RTOL)
    del cpu, model, out, enc, cond, cond_un, final, batch
    torch.cuda.empty_cache()
    phase(f"EgoHMR reference: card path agrees with the CPU plain path (B=2, 512 points, "
          f"224x224 crops, {S} steps with shared noise)", t)

    # ---- 20-21. each CLI on one full-width batch (the 16-example test split)
    for label, cli in (("test_prohmr_scene", test_prohmr_scene), ("test_egohmr", test_egohmr)):
        t = time.perf_counter()
        result, counts = counted(lambda: cli.main(["--batch_size", "16", "--scene_points",
                                                   str(HMR_POINTS)]))
        expected = egohmr_counts(e_cfg, S) if cli is test_egohmr else pointnet_256
        require(counts == expected, f"{label} CLI launch counts {counts}")
        require(all(math.isfinite(v) for v in result.values()) and "MPJPE" in result,
                f"{label} CLI metrics {result}")
        record(f"{label}_cli", counts)
        phase(f"CLI {label} (full width, one batch of 16, {HMR_POINTS} points): launches "
              f"{counts}, {json.dumps({k: round(v, 3) for k, v in result.items()})} mm", t)


def gcn_phase(dev, model, enc, vis, x0, gen) -> dict:
    """Phase 66: the GCN kernels on `model`'s weights and a batch's encoded
    features: one step and the final prediction against the plain path on
    the card, and the times of one hidden conv, a step, the eager step and
    the whole reverse process; returns the kernels line's `gcn_fused` row
    (one hidden conv's operations and bytes)."""
    import torch

    from seeme_tpu_torch.ops import _build
    from seeme_tpu_torch.ops import gcn_fused as gfu

    cfg, S = model.cfg, model.sample_schedule.num_train_timesteps
    B, H, L = x0.shape[0], cfg.gcn_hid_dim, cfg.gcn_layers
    rb = model._fused_gcn.batch(model, enc, vis)
    plain = gfu.ReverseBatch(model, None, enc, vis)
    eps = torch.randn(B, 144, generator=gen, device=dev)
    want = gfu.gcn_fused_plain(plain, x0, S - 1, eps)
    err = compare("GCN step, kernels vs plain", gfu.gcn_fused(rb, x0, S - 1, eps), want,
                  float(want.abs().max()), POINTNET_RTOL)
    want = gfu.gcn_fused_plain(plain, x0)
    err = max(err, compare("GCN final prediction, kernels vs plain", gfu.gcn_fused(rb, x0), want,
                           float(want.abs().max()), POINTNET_RTOL))
    w, (a, h) = rb.weights, rb.hl
    lib, stream = _build.load_library(), _build.stream_ptr(dev)

    def conv():
        _build.check(lib.gcn_conv(
            a.data_ptr(), w["conv1.w"].data_ptr(), w["conv1.m"].data_ptr(),
            w["conv1.adj"].data_ptr(), w["conv1.scale"].data_ptr(), w["conv1.shift"].data_ptr(),
            None, None, h.data_ptr(), a.shape[0], H, stream), "gcn_conv")

    def reverse():
        x = x0
        for t in range(S - 1, -1, -1):
            x = gfu.gcn_fused(rb, x, t, eps if t > 0 else None)
        return gfu.gcn_fused(rb, x)

    rows = 2 * B * 24
    block = model.diffusion_model.gconv_layers[0].gconv1
    f32_rows = rb.xf[:rows].reshape(2 * B, 24, H)
    ms = time_ms(conv, 50)
    plain_ms = time_ms(lambda: block(f32_rows), 5)
    step_ms = time_ms(lambda: gfu.gcn_fused(rb, x0, S - 1, eps), 20)
    eager_step_ms = time_ms(lambda: gfu.gcn_fused_plain(plain, x0, S - 1, eps), 5)
    reverse_ms = time_ms(reverse, 3)
    flops = 2.0 * rows * H * 2 * H
    nbytes = tensor_bytes(a, h, w["conv1.w"])
    # the split-TF32 scheme's least time: three TF32 products for each f32 one
    floor = 1e3 * max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)
    print(f"    GCN (B={B}, H={H}, {L} residual blocks): hidden conv {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s of its f32 count; bound {bound_ms(flops, nbytes):.4f} "
          f"ms, split-TF32 floor {floor:.4f} ms), its eager block {plain_ms:.4f} ms; "
          f"a step ({2 * L + 2} launches) {step_ms:.4f} ms, eager {eager_step_ms:.4f} ms; "
          f"{S} steps and the final prediction {reverse_ms:.3f} ms", flush=True)
    return dict(name="gcn_fused", route="cuda", source="seeme_tpu_torch/csrc/gcn.cu",
                replaces="none: the JAX package leaves the GCN to XLA", hidden=H,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, floor_ms=floor, step_ms=step_ms,
                eager_step_ms=eager_step_ms, reverse_ms=reverse_ms, bytes=nbytes, flops=flops)


def t2m_phases(dev, counted, counters, record, work: str) -> None:
    """Phases 22-26: the HumanML3D text-to-motion model trained and
    evaluated through the CLIs at full width (B = 64, 196 x 263) in `work`:
    both stages, sampling on the trained weights at the preset's guidance
    1.0 and at 7.5, the test CLI with MultiModality, the diffusion-only
    model and the token text mode, each counted and held to the CPU."""
    import torch

    from seeme_tpu_torch.data.humanml import SyntheticT2MDataset
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
    from seeme_tpu_torch.models.text_encoder import ClipTextEncoder
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.test.__main__ import main as test_main
    from seeme_tpu_torch.train.__main__ import Trainer, main, parse_args
    from seeme_tpu_torch.train.loop import train_step, validate
    from seeme_tpu_torch.train.state import make_optimizer, set_stage

    none = {k: 0 for k in counters}
    tok = {**none, "ddim_tok_t1": 1}

    def report(trainer):
        """Losses, per-step ms (after one warm-up step) and the epoch means."""
        losses = [x["total"] for r in trainer.history for x in r["steps"]]
        ms = sorted(m for r in trainer.history for m in r["step_ms"][int(r is trainer.history[0]):])
        require(all(math.isfinite(v) for v in losses), f"losses not finite: {losses}")
        first, last = trainer.history[0]["means"]["total"], trainer.history[-1]["means"]["total"]
        busy, wall, _ = device_busy(trainer, 3)
        return (f"{len(losses)} steps, losses {[round(v, 5) for v in losses]}, epoch means "
                f"{first:.5f} -> {last:.5f}, {ms[len(ms) // 2]:.3f} ms a step (median of "
                f"{len(ms)}, min {ms[0]:.3f}, max {ms[-1]:.3f}), device idle share "
                f"{1 - busy / wall:.3f} over 3 more steps"), first, last, len(losses)

    def fixed_eval_loss(trainer):
        set_stage(trainer.system, None)
        out = validate(trainer.system, trainer.stage, trainer.val_batches())["total"]
        set_stage(trainer.system, trainer.stage)
        return out

    def card_vs_cpu_step(stage, **kw):
        """One step at the CPU tests' size (d 32, 3 layers, 24 frames, B 3,
        dropout 0) on both devices with the same draws."""
        data = SyntheticT2MDataset(3, 24, 8, seed=SEED, text_dim=48)
        cfg = T2MConfig(latent_dim=(1, 32), ff_size=16, num_layers=3, text_encoded_dim=48,
                        max_len=24, dropout=0.0, **kw)
        runs = {}
        for device in ("cpu", dev):
            sys_ = T2MSystem(cfg, data.mean, data.std, device=device, seed=SEED)
            perturb_parameters_(sys_, torch.Generator().manual_seed(SEED + 21))
            runs[str(device)] = (sys_, *make_optimizer(stage, sys_, lr=TRAIN_LR))
        cpu_batch = to_torch(data.batch(0, 3), "cpu")
        draws = runs["cpu"][0].loss_draws(stage, cpu_batch, torch.Generator().manual_seed(SEED + 22))
        out = {}
        for device, (sys_, opt, sched) in runs.items():
            on = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in cpu_batch.items()}
            out[device] = train_step(sys_, stage, opt, sched, 0, on,
                                     draws={k: v.to(device) for k, v in draws.items()})["total"]
        compare_step(stage, runs["cpu"][0], runs[str(dev)][0], out["cpu"], out[str(dev)], TRAIN_LR)

    def card_vs_cpu_sample(system, text, name, cond_mask=None, gate_joints=True):
        """`sample` of the same weights at B = 2 on the CPU's plain path and
        on the card: features, and joints recovered in float64 on both.
        Without `gate_joints` the joints' gap is printed, split into the
        recovery's own (gated) and the features' gap carried through the
        CPU's recovery: RIC integrates the root's rotation and velocity
        over 196 frames, so on the large features of a barely trained model
        it magnifies a feature gap far inside the gate into a joint gap
        over it."""
        cfg = system.cfg
        cpu = T2MSystem(cfg, system.mean.cpu(), system.std.cpu(), device="cpu", seed=SEED)
        cpu.load_state_dict({k: v.cpu() for k, v in system.state_dict().items()})
        shape = (2, cfg.max_len, cfg.nfeats) if system.diffusion_only else (2, *cfg.latent_dim)
        z = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 23))
        mask = None if cond_mask is None else cond_mask[:2].cpu()
        ref = cpu.sample(text[:2].cpu(), cond_mask=mask, z_init=z)
        got = system.sample(text[:2], cond_mask=None if mask is None else mask.to(dev),
                            z_init=z.to(dev))
        compare(f"{name} features, card vs CPU", got.cpu(), ref, float(ref.abs().max()),
                SLICE_RTOL)
        ref_j = cpu.feats_to_joints(ref)
        got_j = system.feats_to_joints(got).cpu()
        if gate_joints:
            compare(f"{name} joints (float64 recovery), card vs CPU", got_j, ref_j,
                    float(ref_j.abs().max()), SLICE_RTOL)
            return
        scale = float(ref_j.abs().max())
        compare(f"{name} RIC recovery (float64), card vs CPU on the same features",
                system.feats_to_joints(ref.to(dev)).cpu(), ref_j, scale, SLICE_RTOL)
        carried = float((cpu.feats_to_joints(got.cpu()) - ref_j).abs().max())
        print(f"    {name} joints, card vs CPU (not gated): relative "
              f"{float((got_j - ref_j).abs().max()) / scale:.3e}, of which the features' gap "
              f"through the CPU recovery {carried / scale:.3e} (max |joint| {scale:.4g}, max "
              f"|feature| {float(ref.abs().max()):.4g})", flush=True)

    # ---- 22. stage 1
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    s1, counts = counted(lambda: main(["--preset", "vae_humanml3d", "--epochs", "2",
                                       "--out", os.path.join(work, "s1")]))
    peak = torch.cuda.max_memory_allocated()
    require(counts == none, f"t2m stage 1 launch counts {counts}")
    record("t2m_train_stage1", counts)
    text, first, last, n = report(s1)
    require(n >= 5 and last < first, f"t2m stage 1: {n} steps, epoch means {first} -> {last}")
    card_vs_cpu_step("vae")
    phase(f"t2m train stage 1 (vae_humanml3d, B={s1.batch_size}, {s1.system.cfg.max_len} x "
          f"{s1.system.cfg.nfeats}): {text}, peak memory {peak} B, launches {counts}; one "
          f"step card vs CPU agrees", t)

    # ---- 23. stage 2, then sampling on its weights at guidance 1.0 and 7.5
    t = time.perf_counter()
    s2 = Trainer(parse_args(["--preset", "mld_humanml3d", "--epochs", "2", "--out",
                             os.path.join(work, "s2"), "--pretrained_vae", s1.checkpoints[-1],
                             "train.val_every_steps=2"]))
    saved = torch.load(s1.checkpoints[-1], map_location=dev, weights_only=False)["state_dict"]
    vae = {k[len("vae."):]: v for k, v in saved.items() if k.startswith("vae.")}
    require(all(torch.equal(v, vae[k]) for k, v in s2.system.vae.state_dict().items()),
            "t2m stage 2 did not load the stage-1 VAE")
    den = {k: v.clone() for k, v in s2.system.denoiser.state_dict().items()}
    val_before = fixed_eval_loss(s2)
    torch.cuda.reset_peak_memory_stats()
    _, counts = counted(s2.fit)
    peak = torch.cuda.max_memory_allocated()
    require(counts == none, f"t2m stage 2 launch counts {counts}")
    record("t2m_train_stage2", counts)
    val_after = fixed_eval_loss(s2)
    require(all(torch.equal(v, vae[k]) for k, v in s2.system.vae.state_dict().items()),
            "t2m stage 2 changed the VAE")
    require(any(not torch.equal(v, den[k]) for k, v in s2.system.denoiser.state_dict().items()),
            "t2m stage 2 did not change the denoiser")
    require(val_after < val_before, f"t2m fixed-draw val loss {val_before} -> {val_after}")
    text, first, last, n = report(s2)
    require(n >= 5, f"t2m stage 2 took {n} steps")
    card_vs_cpu_step("diffusion", guidance_scale=1.0)
    phase(f"t2m train stage 2 (mld_humanml3d, B={s2.batch_size}): {text}, fixed-draw val "
          f"{val_before:.5f} -> {val_after:.5f}, peak memory {peak} B, launches {counts}, VAE "
          f"bitwise unchanged; one step card vs CPU agrees", t)

    t = time.perf_counter()
    system = s2.system
    set_stage(system, None)
    vb = to_torch(next(s2.datamodule.batches("val", s2.batch_size, shuffle=False)), dev)
    emb = vb["text_emb"][:, None, :].contiguous()
    cfg75 = dataclasses.replace(system.cfg, guidance_scale=7.5)
    cfg_system = T2MSystem(cfg75, system.mean, system.std, device=dev, seed=SEED)
    cfg_system.load_state_dict(system.state_dict())
    z0 = torch.randn(emb.shape[0], 1, 256, generator=torch.Generator().manual_seed(SEED + 24)).to(dev)
    for g, sys_ in ((1.0, system), (7.5, cfg_system)):
        feats, counts = counted(lambda: sys_.sample(emb, z_init=z0))
        require(counts == tok, f"t2m sampling at guidance {g}: launch counts {counts}")
        record(f"t2m_sample_after_training_g{g}", counts)
        sd, weights = sys_.kernel_operands()
        cond = torch.cat([torch.zeros_like(emb), emb]) if g > 1 else emb
        args = (sd, cond.contiguous(), z0, sys_.schedule, 50, sys_.cfg.num_layers, g)
        z_p = dfu.ddim_fused_plain(*args, md_trans=False)
        compare(f"ddim_tok on the trained weights, guidance {g} ({cond.shape[0]} condition rows)",
                dfu.ddim_fused_tok(*args, weights=weights), z_p, float(z_p.abs().max()), DDIM_RTOL)
        ms = time_ms(lambda: dfu.ddim_fused_tok(*args, weights=weights), 3)
        flops = tok_flops(sd, sys_.cfg.num_layers, cond.shape[0], 1, 50)
        nbytes = 4 * (sum(v.numel() for v in sd.values()) + cond.numel() + 2 * z0.numel() + 100)
        print(f"    kernel ddim_tok_t1 at this shape: {ms:.3f} ms, bound "
              f"{bound_ms(flops, nbytes):.4f} ms ({bound_by(flops, nbytes)}), f32 bound "
              f"{bound_f32_ms(flops, nbytes):.4f} ms", flush=True)
        require(bool(torch.isfinite(feats).all()), "t2m sampled features not finite")
        card_vs_cpu_sample(sys_, emb, f"t2m trained, guidance {g}")
    phase(f"t2m sampling after training (B={emb.shape[0]}, text width {emb.shape[-1]}): one "
          f"token-kernel launch at guidance 1.0 and at 7.5; card vs CPU at B=2 agrees", t)
    del cfg_system

    # ---- 24. the test CLI, in process
    t = time.perf_counter()
    result, counts = counted(lambda: test_main([
        "--preset", "mld_humanml3d", "--checkpoint", s2.checkpoints[-1], "--replication_times",
        "2", "--count_time", "--out", os.path.join(work, "test"), "test.mm=True",
        "test.mm_num_samples=32", "test.mm_num_repeats=8"]))
    batches = -(-64 // s2.batch_size)  # the synthetic test split, padded tail counted
    require(counts == {**none, "ddim_tok_t1": 2 * batches + 8}, f"t2m test CLI launches {counts}")
    record("t2m_test_cli", counts)
    stats = result["stats"]
    require({"MPJPE", "PAMPJPE", "ACCEL", "FID", "R_precision_top_1", "Matching_score",
             "Diversity", "MultiModality"} <= set(stats)
            and all(math.isfinite(x) for v in stats.values() for x in v.values()),
            f"t2m test CLI statistics {stats}")
    require(os.path.exists(os.path.join(work, "test", "times.txt"))
            and os.path.exists(result["metrics_path"]), "times.txt or metrics_*.json missing")
    vae_result, vae_counts = counted(lambda: test_main([
        "--preset", "vae_humanml3d", "--checkpoint", s1.checkpoints[-1], "--out",
        os.path.join(work, "test_vae")]))
    require(vae_counts == none, f"t2m stage-1 test CLI launches {vae_counts}")
    record("t2m_test_cli_vae", vae_counts)
    require(all(math.isfinite(v["mean"]) for v in vae_result["stats"].values()),
            f"t2m stage-1 test CLI statistics {vae_result['stats']}")
    times = result["times"]
    phase(f"t2m test CLI (mld_humanml3d, 2 replications of {batches} batch over the 64-sample "
          f"test split, MultiModality 32 x 8): launches {counts}, batch seconds "
          f"{[round(x, 4) for x in times]}, means "
          f"{json.dumps({k: round(v['mean'], 4) for k, v in sorted(stats.items())})}; stage-1 "
          f"preset reconstructs with launches {vae_counts}", t)
    del s1, s2, system
    torch.cuda.empty_cache()

    # ---- 25. the diffusion-only model: one step, then sampling through the loop
    t = time.perf_counter()
    nv = Trainer(parse_args(["--preset", "novae_humanml3d", "--out", os.path.join(work, "nv")]))
    batch = to_torch(next(nv.train_batches(0)), dev)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(2):  # the first warms up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        terms, counts = counted(lambda: train_step(nv.system, "diffusion", nv.optimizer,
                                                   nv.schedule, i, batch, nv.generator))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        require(counts == none and math.isfinite(terms["total"]), f"novae step {terms} {counts}")
    peak = torch.cuda.max_memory_allocated()
    record("t2m_novae_train_step", counts)
    system = nv.system
    set_stage(system, None)
    emb = batch["text_emb"][:32, None, :]
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    feats, counts = counted(lambda: system.sample(emb, generator=torch.Generator(device=dev)
                                                  .manual_seed(SEED + 25)))
    sample_s = time.perf_counter() - t_s
    require(counts == none, f"novae sampling launches {counts}")
    record("t2m_novae_sampling", counts)
    require(tuple(feats.shape) == (32, 196, 263) and bool(torch.isfinite(feats).all()),
            f"novae features {tuple(feats.shape)}")
    card_vs_cpu_sample(system, emb, "novae, guidance 7.5", gate_joints=False)
    phase(f"t2m novae (trans_dec 9 x 512, 4 heads): a step at B={batch['motion'].shape[0]} "
          f"{step_ms[-1]:.3f} ms (first {step_ms[0]:.3f}), peak memory {peak} B; sampling "
          f"B=32 x 196 x 263, 50 steps at guidance 7.5 through the loop {sample_s:.3f} s, "
          f"launches {counts}; card vs CPU at B=2 agrees", t)
    del nv, system, feats
    torch.cuda.empty_cache()

    # ---- 26. the token text mode: 77 hashed-word tokens with their mask, through the loop
    t = time.perf_counter()
    cfg = dataclasses.replace(T2MConfig(), text_encoded_dim=256, guidance_scale=1.0)
    data = SyntheticT2MDataset(BATCH, cfg.max_len, seed=SEED, text_dim=256)
    system = T2MSystem(cfg, data.mean, data.std, device=dev, seed=SEED)
    perturb_parameters_(system, torch.Generator().manual_seed(SEED + 26))
    encoder = ClipTextEncoder(None, latent_dim=256, last_hidden_state=True)
    texts = data.texts
    tokens = torch.as_tensor(encoder(texts), device=dev)
    mask = torch.as_tensor(encoder.token_mask(texts), device=dev)
    require(encoder.name == "clip_hidden" and tuple(tokens.shape) == (BATCH, 77, 256),
            f"token mode {encoder.name} {tuple(tokens.shape)}")
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    feats, counts = counted(lambda: system.sample(tokens, cond_mask=mask,
                                                  generator=torch.Generator(device=dev)
                                                  .manual_seed(SEED + 27)))
    sample_s = time.perf_counter() - t_s
    require(counts == none and bool(torch.isfinite(feats).all()),
            f"token mode launches {counts}")
    record("t2m_token_mode_sampling", counts)
    card_vs_cpu_sample(system, tokens, "token mode", cond_mask=mask, gate_joints=False)
    phase(f"t2m token text mode (clip_hidden fallback, 77 tokens, {int(mask[0].sum())} valid in "
          f"row 0): B={BATCH} through the loop {sample_s:.3f} s, launches {counts}; card vs CPU "
          f"at B=2 agrees", t)


def hmr_train_phases(dev, counted, counters, record, kernels: list, work: str) -> None:
    """Phases 27-29: the fused PointNet's backward at both widths, then
    ProHMR-Scene and EgoHMR trained through their CLIs at full width in
    `work`, each step counted, timed at B = 64 with 20 000 points, held to
    the CPU for one step, and its checkpoint evaluated by its test CLI."""
    import numpy as np
    import torch

    from seeme_tpu_torch import test_egohmr, test_prohmr_scene, train_egohmr
    from seeme_tpu_torch import train_prohmr_scene as train_prohmr
    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.data import egohmr_images as images
    from seeme_tpu_torch.data.augmentation import MoCapDataset
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
    from seeme_tpu_torch.models.prohmr import GENERATOR, LOSS_WEIGHTS, ProHMRConfig, ProHMRScene
    from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
    from seeme_tpu_torch.nn.pointnet import ResnetPointnet
    from seeme_tpu_torch.ops import pointnet_fused as pfu

    none = {k: 0 for k in counters}
    rows = {k["name"]: k for k in kernels}

    def per_width(width):
        return {**none, **({"pointnet_input_block_h256": 1, "pointnet_split_block_h256": 3}
                           if width == 256 else
                           {"pointnet_input_block": 1, "pointnet_split_block": 3})}

    # ---- 27. the PointNet backward: the Function against the plain twin
    for H, b, n in ((256, BATCH, HMR_POINTS), (512, 16, HMR_POINTS)):
        t = time.perf_counter()
        net = ResnetPointnet(512, hidden_dim=H)
        init_parameters_(net, torch.Generator().manual_seed(SEED + 60))
        perturb_parameters_(net, torch.Generator().manual_seed(SEED + 61))
        net = net.to(dev).requires_grad_(True)
        g = torch.Generator().manual_seed(SEED + 62)
        points = torch.randn(b, n, 3, generator=g).to(dev)
        proj = torch.randn(b, 512, generator=g).to(dev)
        fused = pfu.FusedPointnet()

        def fused_loss():
            return (fused(net, points) * proj).sum()

        def plain_loss():
            return (net(points) * proj).sum()

        grads, peaks = {}, {}
        for label, loss_fn in (("fused", fused_loss), ("plain", plain_loss)):
            net.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if label == "fused":
                _, counts = counted(lambda: loss_fn().backward())
                require(counts == per_width(H), f"PointNet backward H={H} launch counts {counts}")
            else:
                loss_fn().backward()
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated()
            grads[label] = {k: p.grad.clone() for k, p in net.named_parameters()}
        worst = 0.0
        for k, want in grads["plain"].items():
            scale = float(want.abs().max())
            gap = float((grads["fused"][k] - want).abs().max())
            require(gap <= TRAIN_GRAD_RTOL * scale,
                    f"PointNet backward H={H} {k}: {gap:.3e} of max |g| {scale:.3e}")
            worst = max(worst, gap / scale)
        net.zero_grad(set_to_none=True)
        fwd_ms, plain_fwd_ms = time_ms(fused_loss, 3), time_ms(plain_loss, 3)  # grad mode on
        bwd_ms = time_ms(lambda: fused_loss().backward(), 3) - fwd_ms
        plain_bwd_ms = time_ms(lambda: plain_loss().backward(), 3) - plain_fwd_ms
        report = {"batch": b, "points": n, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
                  "plain_forward_ms": plain_fwd_ms, "plain_backward_ms": plain_bwd_ms,
                  "peak_bytes": peaks["fused"], "plain_peak_bytes": peaks["plain"],
                  "worst_grad_gap": worst}
        suffix = "_h256" if H == 256 else ""
        for name in (f"pointnet_input_block{suffix}", f"pointnet_split_block{suffix}"):
            rows[name]["backward"] = report
        del net, points, proj, fused, grads
        torch.cuda.empty_cache()
        phase(f"PointNet backward H={H} (B={b}, N={n}; gradients of a seeded projection): worst "
              f"gap {worst:.3e} of max |g| (tolerance {TRAIN_GRAD_RTOL:.0e}); forward "
              f"{fwd_ms:.3f} ms, backward (chunked recompute) {bwd_ms:.3f} ms; the plain twin "
              f"{plain_fwd_ms:.3f} / {plain_bwd_ms:.3f} ms; peak {peaks['fused']} B (plain "
              f"{peaks['plain']} B)", t)

    smpl = synthetic_smpl(n_verts=6890, seed=SEED)
    big = images.EgoHmrImageDataModule(n_pts=HMR_POINTS, img_size=224, smpl=smpl)
    big_batch = next(big.batches("train", BATCH, shuffle=False, augment=True))

    def step_launches(module, name, record_to):
        """Wrap `module.name` so each call's launches of both H = 256 blocks
        land in `record_to`."""
        inner = getattr(module, name)

        def wrapped(*a, **kw):
            before = (pfu.fused_input_block.launches_by_width[256],
                      pfu.fused_split_block.launches_by_width[256])
            out = inner(*a, **kw)
            record_to.append((pfu.fused_input_block.launches_by_width[256] - before[0],
                              pfu.fused_split_block.launches_by_width[256] - before[1]))
            return out

        setattr(module, name, wrapped)
        return lambda: setattr(module, name, inner)

    def min_var(model):
        return min(float(m.running_var.min()) for m in model.modules()
                   if hasattr(m, "running_var"))

    def changed(model, fresh, prefix):
        now = {k: v.cpu() for k, v in model.state_dict().items() if k.startswith(prefix)}
        old = {k: v.cpu() for k, v in fresh.state_dict().items() if k.startswith(prefix)}
        return all(not torch.equal(now[k], old[k]) for k in old)

    def timed_steps(step, n_steps):
        """ms a step (host clock, synchronised) after one warm-up, peak
        memory, device idle share of one more step."""
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n_steps
        busy, wall, _ = profile_busy(step)
        return ms, torch.cuda.max_memory_allocated(), 1 - busy / wall

    def cli_check(label, cli, ckpt):
        t = time.perf_counter()
        result, counts = counted(lambda: cli.main(["--batch_size", "16", "--checkpoint", ckpt]))
        expected = per_width(256)
        if cli is test_egohmr:   # 2 x 4 + 2 GCN launches a step, 50 steps and the final one
            expected["gcn_fused"] = 10 * 51
        require(counts == expected, f"{label} --checkpoint launch counts {counts}")
        require(all(math.isfinite(v) for v in result.values()) and "MPJPE" in result,
                f"{label} --checkpoint metrics {result}")
        record(f"{label}_trained_cli", counts)
        phase(f"CLI {label} --checkpoint (the trained weights, one batch of 16, 1024 points): "
              f"launches {counts}, {json.dumps({k: round(v, 3) for k, v in result.items()})} mm", t)

    # the card-vs-CPU steps: the CLIs' own batch (8) and points (1024), where a
    # ReLU decision of the heads rests on more rows than at B = 2
    args = train_prohmr.parse_args(["--lr", str(TRAIN_LR)])
    cli_b = args.batch_size
    cli_data = images.EgoHmrImageDataModule(n_pts=args.scene_points, img_size=224, smpl=smpl)
    cli_np = next(cli_data.batches("train", cli_b, shuffle=False, augment=True))

    # ---- 28. ProHMR-Scene training through the CLI
    t = time.perf_counter()
    g_calls, d_calls, inits = [], [], []
    restore = [step_launches(train_prohmr, "g_step", g_calls),
               step_launches(train_prohmr, "d_step", d_calls),
               step_launches(ProHMRScene, "initialize_actnorm", inits)]
    try:
        res, counts = counted(lambda: train_prohmr.main(["--out", os.path.join(work, "prohmr")]))
    finally:
        for undo in restore:
            undo()
    model = res["model"]
    steps = len(g_calls)
    actnorm = model.flow.flow._transform._transforms[0].log_scale
    require(len(inits) == 1 and bool(actnorm.abs().max() > 0),
            f"ProHMR ActNorm initialisation: {len(inits)} calls")
    require(steps == 16 and len(d_calls) == steps, f"ProHMR steps {steps} / {len(d_calls)}")
    require(all(c == (1, 3) for c in g_calls) and all(c == (0, 0) for c in d_calls),
            f"ProHMR launches per G step {set(g_calls)}, per D step {set(d_calls)}")
    require(counts == {**none, "pointnet_input_block_h256": steps + 1,
                       "pointnet_split_block_h256": 3 * (steps + 1)},
            f"ProHMR training launch counts {counts}")
    record("prohmr_train", counts)
    losses = res["g_losses"] + res["d_losses"]
    require(all(math.isfinite(v) for v in losses), f"ProHMR losses {losses}")
    fresh = ProHMRScene(ProHMRConfig(), smpl, device=dev)
    require(changed(model, fresh, "scene_enc.") and changed(model, fresh, "discriminator.")
            and changed(model, fresh, "backbone.bn1."), "ProHMR training left a subtree unchanged")
    del fresh
    phase(f"ProHMR-Scene training (CLI defaults: B=8, 1024 points, 2 epochs, {steps} G + D "
          f"steps): launches {counts} (1 / 3 per G step and in the ActNorm start's context, 0 "
          f"per D step), G losses {[round(v, 4) for v in res['g_losses']]}, D losses "
          f"{[round(v, 5) for v in res['d_losses']]}, scene_enc, backbone statistics and "
          f"discriminator changed, smallest batch-norm variance {min_var(model):.4e}", t)

    t = time.perf_counter()
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    runs = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        m = ProHMRScene(ProHMRConfig(), smpl, device=device)
        m.load_state_dict({k: v.to(device) for k, v in sd.items()})
        gp = []
        for key in GENERATOR:
            getattr(m, key).requires_grad_(True)
            gp += list(getattr(m, key).parameters())
        m.discriminator.requires_grad_(True)
        runs[where] = (m, gp, train_prohmr.adamw(gp, args),
                       train_prohmr.adamw(m.discriminator.parameters(), args))
    draws = runs["cpu"][0].train_draws(cli_b, torch.Generator().manual_seed(SEED + 64))
    # the card's steps run first and record their ReLU decisions, which the CPU's take
    mocap_np = next(MoCapDataset(None).batches(cli_b * model.cfg.num_train_samples,
                                               np.random.RandomState(3)))
    out, g_masks, d_masks, d_out = {}, [], [], {}
    for where, (m, gp, og, od) in runs.items():
        with relu_decisions(m, g_masks, record=where == "card"):
            terms, fake = train_prohmr.g_step(m, og, gp, to_torch(cli_np, m.device),
                                              {k: v.to(m.device) for k, v in draws.items()})
        out[where] = (float(terms["loss"] + LOSS_WEIGHTS["ADVERSARIAL"]
                            * terms["loss_gen"]), fake)
    compare_step("ProHMR G step", runs["cpu"][0], runs["card"][0], out["cpu"][0],
                 out["card"][0], TRAIN_LR)
    for where, (m, gp, og, od) in runs.items():
        with relu_decisions(m, d_masks, record=where == "card"):
            d_out[where] = float(train_prohmr.d_step(m, od, to_torch(mocap_np, m.device),
                                                     out[where][1]))
    compare_step("ProHMR D step", runs["cpu"][0], runs["card"][0], d_out["cpu"],
                 d_out["card"], TRAIN_LR)
    del runs
    torch.cuda.empty_cache()
    phase(f"ProHMR-Scene card vs CPU: one G step and one D step at B={cli_b}, "
          f"{args.scene_points} points, 224x224, shared draws and ReLU decisions", t)
    t = time.perf_counter()
    model.requires_grad_(False)
    g_params = []
    for key in GENERATOR:
        getattr(model, key).requires_grad_(True)
        g_params += list(getattr(model, key).parameters())
    model.discriminator.requires_grad_(True)
    opt_g = train_prohmr.adamw(g_params, args)
    opt_d = train_prohmr.adamw(model.discriminator.parameters(), args)
    batch = to_torch(big_batch, dev)
    mocap = MoCapDataset(None).batches(2 * BATCH, np.random.RandomState(3))
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)

    def gd_step():
        _, fake = train_prohmr.g_step(model, opt_g, g_params, batch,
                                      model.train_draws(BATCH, gen))
        train_prohmr.d_step(model, opt_d, to_torch(next(mocap), dev), fake)

    (ms, peak, idle), counts = counted(lambda: timed_steps(gd_step, 3))
    require(counts["pointnet_input_block_h256"] == 5, f"ProHMR timed steps' launches {counts}")
    phase(f"ProHMR-Scene G + D step at B={BATCH}, {HMR_POINTS} points, 224x224: {ms:.3f} ms a "
          f"step, peak {peak} B, device idle share {idle:.3f}", t)
    del batch, opt_g, opt_d, model
    torch.cuda.empty_cache()

    cli_check("test_prohmr_scene", test_prohmr_scene, res["checkpoint"])

    # ---- 29. EgoHMR training through the CLI
    t = time.perf_counter()
    calls = []
    undo = step_launches(train_egohmr, "train_step", calls)
    try:
        res, counts = counted(lambda: train_egohmr.main(["--out", os.path.join(work, "egohmr")]))
    finally:
        undo()
    model = res["model"]
    steps = len(calls)
    require(steps == 16 and all(c == (1, 3) for c in calls),
            f"EgoHMR steps {steps}, launches per step {set(calls)}")
    require(counts == {**none, "pointnet_input_block_h256": steps,
                       "pointnet_split_block_h256": 3 * steps},
            f"EgoHMR training launch counts {counts}")
    record("egohmr_train", counts)
    require(all(math.isfinite(v) for v in res["losses"] + res["mse"]),
            f"EgoHMR losses {res['losses']}")
    fresh = EgoHmr(EgoHmrConfig(), smpl, device=dev)
    require(changed(model, fresh, "scene_enc.")
            and changed(model, fresh, "diffusion_model.gconv_input.0.bn."),
            "EgoHMR training left the scene encoder or the GCN's statistics unchanged")
    del fresh
    phase(f"EgoHMR training (CLI defaults: B=8, 1024 points, 2 epochs, {steps} steps): launches "
          f"{counts} (1 / 3 a step), losses {[round(v, 4) for v in res['losses']]}, MSE "
          f"{[round(v, 4) for v in res['mse']]}, scene_enc and GCN statistics changed, smallest "
          f"batch-norm variance {min_var(model):.4e}", t)

    t = time.perf_counter()
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    runs = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        m = EgoHmr(EgoHmrConfig(), smpl, device=device)
        m.load_state_dict({k: v.to(device) for k, v in sd.items()})
        m.requires_grad_(True)
        runs[where] = (m, train_egohmr.adamw(m.parameters(), args))
    draws = runs["cpu"][0].train_draws(cli_b, torch.Generator().manual_seed(SEED + 66))
    draws["drop"][0] = True  # one sample's image block dropped
    out, masks = {}, []
    for where, (m, opt) in runs.items():
        b = train_egohmr.add_body_rep(m, to_torch(cli_np, m.device))
        with relu_decisions(m, masks, record=where == "card"):
            out[where] = float(train_egohmr.train_step(
                m, opt, b, {k: v.to(m.device) for k, v in draws.items()})["total"])
    compare_step("EgoHMR step", runs["cpu"][0], runs["card"][0], out["cpu"], out["card"],
                 TRAIN_LR)
    del runs
    torch.cuda.empty_cache()
    phase(f"EgoHMR card vs CPU: one step at B={cli_b}, {args.scene_points} points, 224x224, "
          f"shared draws and ReLU decisions (one sample's image block dropped)", t)
    t = time.perf_counter()
    model.requires_grad_(True)
    opt = train_egohmr.adamw(model.parameters(), args)
    batch = train_egohmr.add_body_rep(model, to_torch(big_batch, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 65)
    (ms, peak, idle), counts = counted(lambda: timed_steps(
        lambda: train_egohmr.train_step(model, opt, batch, model.train_draws(BATCH, gen)), 3))
    require(counts["pointnet_input_block_h256"] == 5, f"EgoHMR timed steps' launches {counts}")
    phase(f"EgoHMR step at B={BATCH}, {HMR_POINTS} points, 224x224: {ms:.3f} ms a step, peak "
          f"{peak} B, device idle share {idle:.3f}", t)
    del batch, opt, model
    torch.cuda.empty_cache()

    cli_check("test_egohmr", test_egohmr, res["checkpoint"])


def a2m_phases(dev, counted, counters, record, kernels: list, launches: dict, work: str) -> None:
    """Phases 30-32: the HumanAct12 / UESTC action-to-motion model on the
    card at full width (latent 256, ff 128, 5 layers, 60 x 150): the
    sampling slice at B = 64 for both class counts at guidance 1.0 and 7.5
    (kernel 5 once a `sample`, against its plain version, parts timed, card
    vs CPU), both training stages through the CLI, and the test CLI with
    both evaluators, each counted; adds kernel 5's row at the a2m shape."""
    import torch

    from seeme_tpu_torch.config.a2m import mld_humanact12
    from seeme_tpu_torch.data.registry import SyntheticA2MDataModule
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.models.a2m import A2MConfig, A2MSystem
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.test.__main__ import action_evaluator, evaluator_inputs
    from seeme_tpu_torch.test.__main__ import main as test_main
    from seeme_tpu_torch.train.__main__ import Trainer, main, parse_args
    from seeme_tpu_torch.train.loop import train_step, validate
    from seeme_tpu_torch.train.state import make_optimizer, set_stage

    none = {k: 0 for k in counters}
    tok = {**none, "ddim_tok_t1": 1}
    B, F = BATCH, 150

    def evaluator(dataset, classes):
        return action_evaluator(dataset, classes, SEED + 30, dev)

    # ---- 30. the sampling slice: both datasets, guidance 1.0 and 7.5
    for dataset, classes in (("humanact12", 12), ("uestc", 40)):
        t = time.perf_counter()
        base = dataclasses.replace(mld_humanact12().model, num_classes=classes)
        data = SyntheticA2MDataModule(classes, name=dataset)
        batch = to_torch(next(data.batches("train", B, shuffle=False)), dev)
        labels, lengths = batch["action"], batch["length"]
        clf = evaluator(dataset, classes)
        system = None
        for g in (1.0, 7.5):
            sys_ = A2MSystem(dataclasses.replace(base, guidance_scale=g), device=dev, seed=SEED)
            if system is None:
                perturb_parameters_(sys_, torch.Generator().manual_seed(SEED + 31))
                system = sys_
            else:
                sys_.load_state_dict(system.state_dict())
            gen = torch.Generator(device=dev).manual_seed(SEED + 32)

            def slice_():
                feats = sys_.sample(labels, lengths, generator=gen)
                logits, emb = clf(evaluator_inputs(sys_, clf, feats), lengths)
                return feats, logits, emb

            torch.cuda.synchronize()
            t_s = time.perf_counter()
            (feats, logits, emb), counts = counted(slice_)
            slice_s = time.perf_counter() - t_s
            require(counts == tok, f"a2m {dataset} sampling at guidance {g}: launches {counts}")
            record(f"a2m_{dataset}_sampling_g{g}", counts)
            require(tuple(feats.shape) == (B, 60, F) and all(bool(torch.isfinite(x).all())
                                                             for x in (feats, logits, emb)),
                    f"a2m {dataset} outputs {tuple(feats.shape)}")
            # kernel 5 against its plain version on the same condition rows
            sd, weights = sys_.kernel_operands()
            z0 = torch.randn(B, 1, 256, generator=torch.Generator().manual_seed(SEED + 33)).to(dev)
            with torch.no_grad():
                cond = sys_.embed_action(labels)
                if g > 1:
                    cond = torch.cat([torch.zeros_like(cond), cond])
            args = (sd, cond.contiguous(), z0, sys_.schedule, 50, base.num_layers, g)
            z_k = dfu.ddim_fused_tok(*args, weights=weights)
            z_p = dfu.ddim_fused_plain(*args, md_trans=False)
            err = compare(f"a2m {dataset} ddim_tok guidance {g} ({cond.shape[0]} condition rows)",
                          z_k, z_p, float(z_p.abs().max()), DDIM_RTOL)
            print_launch(dfu.cluster_launch(False, B, 1, weights, g))
            ms = time_ms(lambda: dfu.ddim_fused_tok(*args, weights=weights), 5)
            plain_ms = time_ms(lambda: dfu.ddim_fused_plain(*args, md_trans=False), 2)
            flops = tok_flops(sd, base.num_layers, cond.shape[0], 1, 50)
            nbytes = 4 * (sum(v.numel() for v in sd.values()) + cond.numel() + 2 * z0.numel()
                          + 2 * 50)
            parts = {"embed": time_ms(lambda: sys_.embed_action(labels), 10),
                     "kernel": ms,
                     "decode": time_ms(lambda: sys_.vae.decode(z_k, 60, lengths), 5),
                     "fk": time_ms(lambda: sys_.feats_to_joints(feats), 5),
                     "evaluator": time_ms(lambda: clf(evaluator_inputs(sys_, clf, feats),
                                                      lengths), 5)}
            if dataset == "humanact12" and g == 1.0:  # the shipped config's shape
                launches["ddim_tok_t1_a2m"] = counts["ddim_tok_t1"]
                kernels.append(dict(name="ddim_tok_t1_a2m", counter="ddim_tok_t1", route="cuda",
                                    source="seeme_tpu_torch/csrc/ddim_tok_t1.cu",
                                    replaces="seeme_tpu/ops/denoiser_fused.py:597",
                                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                    flops=flops))
            # card vs CPU at B = 2 on the plain path, same weights and noise
            cpu = A2MSystem(sys_.cfg, device="cpu", seed=SEED)
            cpu.load_state_dict({k: v.cpu() for k, v in sys_.state_dict().items()})
            z2 = torch.randn(2, 1, 256, generator=torch.Generator().manual_seed(SEED + 34))
            ref = cpu.sample(labels[:2].cpu(), lengths[:2].cpu(), z_init=z2)
            got = sys_.sample(labels[:2], lengths[:2], z_init=z2.to(dev))
            compare(f"a2m {dataset} features, guidance {g}, card vs CPU", got.cpu(), ref,
                    float(ref.abs().max()), SLICE_RTOL)
            ref_j = cpu.feats_to_joints(ref)
            compare(f"a2m {dataset} joints, guidance {g}, card vs CPU",
                    sys_.feats_to_joints(got).cpu(), ref_j, float(ref_j.abs().max()), SLICE_RTOL)
            phase(f"a2m slice {dataset} ({classes} classes, {type(clf).__name__}) B={B}, guidance "
                  f"{g}: sample -> FK -> evaluator {slice_s:.3f} s, launches {counts}; kernel 5 "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms(flops, nbytes):.4f} ms "
                  f"({bound_by(flops, nbytes)}), f32 bound {bound_f32_ms(flops, nbytes):.4f} ms; "
                  f"parts alone (ms, CUDA events) "
                  f"{json.dumps({k: round(v, 3) for k, v in parts.items()})}; card vs CPU at "
                  f"B=2 agrees", t)
            t = time.perf_counter()
        del system, sys_, cpu, clf
    torch.cuda.empty_cache()

    # ---- 31. both training stages through the CLI
    def report(trainer):
        losses = [x["total"] for r in trainer.history for x in r["steps"]]
        ms = sorted(m for r in trainer.history for m in r["step_ms"][int(r is trainer.history[0]):])
        require(all(math.isfinite(v) for v in losses), f"a2m losses not finite: {losses}")
        first, last = trainer.history[0]["means"]["total"], trainer.history[-1]["means"]["total"]
        busy, wall, _ = device_busy(trainer, 3)
        return (f"{len(losses)} steps, epoch means {first:.5f} -> {last:.5f}, "
                f"{ms[len(ms) // 2]:.3f} ms a step (median of {len(ms)}, min {ms[0]:.3f}, max "
                f"{ms[-1]:.3f}), device idle share {1 - busy / wall:.3f} over 3 more steps"), \
            first, last

    def card_vs_cpu_step(stage):
        """One step at the CPU tests' size (latent 32, 3 layers, 16 frames,
        B 4, dropout 0) on both devices with the same draws."""
        data = SyntheticA2MDataModule(12, num_frames=16)
        cfg = A2MConfig(num_frames=16, latent_dim=(1, 32), ff_size=16, num_layers=3,
                        dropout=0.0, guidance_uncondp=0.25)
        runs = {}
        for device in ("cpu", dev):
            sys_ = A2MSystem(cfg, device=device, seed=SEED)
            perturb_parameters_(sys_, torch.Generator().manual_seed(SEED + 35))
            runs[str(device)] = (sys_, *make_optimizer(stage, sys_, lr=TRAIN_LR))
        cpu_batch = to_torch(next(data.batches("train", 4, shuffle=False)), "cpu")
        cpu_batch["length"] = torch.tensor([16, 12, 16, 8], dtype=torch.int32)
        draws = runs["cpu"][0].loss_draws(stage, cpu_batch,
                                          torch.Generator().manual_seed(SEED + 36))
        out = {}
        for device, (sys_, opt, sched) in runs.items():
            on = {k: v.to(device) for k, v in cpu_batch.items()}
            out[device] = train_step(sys_, stage, opt, sched, 0, on,
                                     draws={k: v.to(device) for k, v in draws.items()})["total"]
        compare_step(f"a2m {stage}", runs["cpu"][0], runs[str(dev)][0], out["cpu"],
                     out[str(dev)], TRAIN_LR)

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    s1, counts = counted(lambda: main(["--preset", "vae_humanact12", "--epochs", "4",
                                       "--out", os.path.join(work, "s1")]))
    peak = torch.cuda.max_memory_allocated()
    require(counts == none, f"a2m stage 1 launch counts {counts}")
    record("a2m_train_stage1", counts)
    text, first, last = report(s1)
    require(last < first, f"a2m stage 1 epoch means {first} -> {last}")
    card_vs_cpu_step("vae")
    phase(f"a2m train stage 1 (vae_humanact12, B={s1.batch_size}, 60 x 150): {text}, peak "
          f"memory {peak} B, launches {counts}; one step card vs CPU agrees", t)

    def fixed_eval_loss(trainer):
        set_stage(trainer.system, None)
        out = validate(trainer.system, trainer.stage, trainer.val_batches())["total"]
        set_stage(trainer.system, trainer.stage)
        return out

    t = time.perf_counter()
    s2 = Trainer(parse_args(["--preset", "mld_humanact12", "--epochs", "4", "--out",
                             os.path.join(work, "s2"), "--pretrained_vae", s1.checkpoints[-1]]))
    saved = torch.load(s1.checkpoints[-1], map_location=dev, weights_only=False)["state_dict"]
    vae = {k[len("vae."):]: v for k, v in saved.items() if k.startswith("vae.")}
    require(all(torch.equal(v, vae[k]) for k, v in s2.system.vae.state_dict().items()),
            "a2m stage 2 did not load the stage-1 VAE")
    trained = {name: {k: v.clone() for k, v in getattr(s2.system, name).state_dict().items()}
               for name in ("denoiser", "embed_action")}
    val_before = fixed_eval_loss(s2)
    torch.cuda.reset_peak_memory_stats()
    _, counts = counted(s2.fit)
    peak = torch.cuda.max_memory_allocated()
    val_after = fixed_eval_loss(s2)
    require(counts == none, f"a2m stage 2 launch counts {counts}")
    record("a2m_train_stage2", counts)
    require(all(torch.equal(v, vae[k]) for k, v in s2.system.vae.state_dict().items()),
            "a2m stage 2 changed the VAE")
    for name, before in trained.items():
        require(any(not torch.equal(v, before[k])
                    for k, v in getattr(s2.system, name).state_dict().items()),
                f"a2m stage 2 did not change {name}")
    require(val_after < val_before, f"a2m fixed-draw val loss {val_before} -> {val_after}")
    text, _, _ = report(s2)
    card_vs_cpu_step("diffusion")
    phase(f"a2m train stage 2 (mld_humanact12, B={s2.batch_size}): {text}, fixed-draw val "
          f"{val_before:.5f} -> {val_after:.5f}, peak memory {peak} "
          f"B, launches {counts}, VAE bitwise unchanged, denoiser and embed_action changed; one "
          f"step card vs CPU agrees", t)

    # ---- 32. the test CLI with each evaluator, on trained weights
    t = time.perf_counter()
    u2 = main(["--preset", "mld_uestc", "--epochs", "1", "--out", os.path.join(work, "u2"),
               "--pretrained_vae", s1.checkpoints[-1]])
    results = {}
    for preset, ckpt in (("mld_humanact12", s2.checkpoints[-1]), ("mld_uestc", u2.checkpoints[-1])):
        result, counts = counted(lambda: test_main([
            "--preset", preset, "--checkpoint", ckpt, "--replication_times", "2",
            "--count_time", "--out", os.path.join(work, f"test_{preset}")]))
        batches = -(-60 // BATCH)  # the 60-sample synthetic test split, padded tail counted
        require(counts == {**none, "ddim_tok_t1": 2 * batches}, f"a2m test CLI {preset} {counts}")
        record(f"a2m_test_cli_{preset}", counts)
        stats = result["stats"]
        require(set(stats) == {"accuracy", "FID", "Diversity", "MultiModality"}
                and all(math.isfinite(x) for v in stats.values() for x in v.values()),
                f"a2m test CLI {preset} statistics {stats}")
        results[preset] = {k: round(v["mean"], 4) for k, v in sorted(stats.items())}
    set_stage(s2.system, None)
    feats = s2.system.sample(torch.arange(BATCH, device=dev) % 12)
    lengths = torch.full((BATCH,), 60, device=dev)
    clf_ms = {}
    for dataset, classes in (("humanact12", 12), ("uestc", 40)):
        clf = evaluator(dataset, classes)
        x = evaluator_inputs(s2.system, clf, feats)
        clf_ms[type(clf).__name__] = time_ms(lambda: clf(x, lengths), 10)
    phase(f"a2m test CLI (2 replications of {batches} batch over the 60-sample test split, "
          f"trained checkpoints): launches {2 * batches} each, metric means "
          f"{json.dumps(results)}; evaluators at B={BATCH} (ms, CUDA events) "
          f"{json.dumps({k: round(v, 3) for k, v in clf_ms.items()})}", t)


MULTI_TOKENS = (2, 10)  # latent token counts past one (MLD-2 ... MLD-10)


def stage1_through_kernel5(system, batch, counted, none, record, path: str) -> None:
    """A stage-1 EgoBody model (MD_TRANS false in its YAML: the token-concat
    stack) samples from `batch` through kernel 5, once, and the kernel
    agrees with its plain version on the same inputs."""
    import torch

    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.train.state import set_stage

    set_stage(system, None)  # eval mode, dropout off: the sampling default
    c, T = system.cfg, system.cfg.latent_dim[0]
    cond = system.encode_conditioning(batch)
    z0 = torch.randn(len(cond), T, 256, generator=torch.Generator().manual_seed(SEED + 57 + T))
    z0 = z0.to(cond.device)
    feats, counts = counted(lambda: system.sample_from_cond(cond, z_init=z0))
    require(not c.md_trans and counts == {**none, f"ddim_tok_t{T}": 1},
            f"{path} launch counts {counts}")
    require(tuple(feats.shape) == (len(cond), c.motion_length, c.nfeats)
            and bool(torch.isfinite(feats).all()), f"{path} features")
    record(path, counts)
    sd, weights, _ = system.kernel_operands()
    args = (sd, cond, z0, system.schedule, c.num_inference_timesteps, c.num_layers,
            c.guidance_scale)
    z_p = dfu.ddim_fused_plain(*args, md_trans=False)
    compare(f"{path}: ddim_fused_tok (NC={cond.shape[1]}) vs plain",
            dfu.ddim_fused_tok(*args, weights=weights), z_p, float(z_p.abs().max()), DDIM_RTOL)


def kernel_row(name, source, err, ms, plain_ms, flops, nbytes, **extra) -> dict:
    return dict(name=name, route="cuda", source=source,
                replaces="seeme_tpu/ops/denoiser_fused.py:597", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bytes=nbytes, flops=flops, **extra)


def multitoken_phases(dev, counted, counters, record, kernels: list, launches: dict,
                      work: str) -> None:
    """Phases 33-36: multi-token latents. 33: kernel 3's general instance at
    T = 2 and 10 against its plain version at B = 64, guidance 1.0 and 2.5,
    T = 1 timed again beside it on the same weights; 34: kernel 5 the same
    way at the T2M shape (text 768, guidance 7.5) and the shipped preset's
    (text 256, guidance 1.0), then `T2MSystem.sample` at T = 2 and 10,
    counted; 35: `config_mld_egobody.yaml` with `model.latent_dim=[2,256]`
    through the port's loader: both training stages through the train CLI's
    `--cfg`, the stage-1 model (`md_trans=False`) through kernel 5 at T = 2,
    the sampling slice on the trained weights (one kernel-3 launch),
    card against CPU at B = 2, and T = 10 sampling counted; 36: the same
    config with `fused_variant: grid` still launches `ddim_fused`."""
    import torch

    from seeme_tpu_torch.config.build import preset_from_yaml
    from seeme_tpu_torch.config.loader import load_config, parse_dotted_overrides
    from seeme_tpu_torch.config.presets import build
    from seeme_tpu_torch.core.masks import lengths_to_mask
    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.data.batch import eval_batches
    from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
    from seeme_tpu_torch.eval.metrics import EgoMetric
    from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
    from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.train.__main__ import Trainer, parse_args
    from seeme_tpu_torch.train.__main__ import main as train_main
    from seeme_tpu_torch.train.loop import validate
    from seeme_tpu_torch.train.state import set_stage

    none = {k: 0 for k in counters}
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    B = BATCH

    # ---- 33. kernel 3 at T = 1, 2, 10
    t = time.perf_counter()
    cfg = SeeMeConfig()
    data = SyntheticEgoDataset(B, cfg.motion_length, scene_points=cfg.scene_points, seed=SEED)
    system = SeeMeSystem(cfg, synthetic_smpl(n_verts=6890, seed=SEED), data.mean, data.std,
                         device=dev, seed=SEED)
    perturb_parameters_(system, torch.Generator().manual_seed(SEED + 1))
    batch = to_torch(data.batch(0, B), dev)
    cond = system.encode_conditioning(batch)
    zeroed = dict(batch, feats=torch.zeros_like(batch["feats"]),
                  transl=torch.zeros_like(batch["transl"]), scene=torch.zeros_like(batch["scene"]))
    cond_cfg = torch.cat([system.encode_conditioning(zeroed), cond]).contiguous()
    sd, weights, _ = system.kernel_operands()
    steps, L = cfg.num_inference_timesteps, cfg.num_layers
    src = "seeme_tpu_torch/csrc/ddim_md.cu"
    t1 = {}
    for T in (1, *MULTI_TOKENS):
        for g, c in ((1.0, cond), (2.5, cond_cfg)):
            z0 = torch.randn(B, T, 256, generator=torch.Generator().manual_seed(SEED + 40 + T))
            args = (sd, c, z0.to(dev), system.schedule, steps, L, g)
            if T == 1:  # held to its plain version in phase 3, on the same weights
                t1[g] = time_ms(lambda: dfu.ddim_fused(*args, weights=weights), 3)
                continue
            z_k = dfu.ddim_fused(*args, weights=weights)
            z_p, plain_ms = timed(lambda: dfu.ddim_fused_plain(*args))
            err = compare(f"ddim_fused T={T} guidance {g}", z_k, z_p, float(z_p.abs().max()),
                          DDIM_RTOL)
            info = dfu.cluster_launch(True, B, c.shape[1], weights, g, tokens=T)
            print_launch(info)
            ms = time_ms(lambda: dfu.ddim_fused(*args, weights=weights), 3)
            flops = ddim_flops(sd, L, c.shape[0], c.shape[1], steps, T)
            nbytes = 4 * (sum(v.numel() for v in sd.values()) + c.numel() + 2 * z0.numel()
                          + 2 * steps)
            phase(f"kernel ddim_md T={T} (B={B}, NC={c.shape[1]}, guidance {g}, {steps} "
                  f"steps, {info.get('samples', '-')} samples a cluster): {ms:.3f} ms (T=1 "
                  f"{t1[g]:.3f} ms), plain {plain_ms:.3f} ms, bound {bound_ms(flops, nbytes):.4f} "
                  f"ms ({bound_by(flops, nbytes)}), f32 bound {bound_f32_ms(flops, nbytes):.4f} ms",
                  t)
            t = time.perf_counter()
            if g == 1.0:
                kernels.append(kernel_row(f"ddim_md_t{T}", src, err, ms, plain_ms, flops, nbytes,
                                          samples_a_cluster=info["samples"],
                                          t1_ms_same_phase=t1[g]))
            else:
                kernels[-1]["guidance_2_5"] = dict(
                    ms=ms, plain_ms=plain_ms, max_abs_err=err, t1_ms_same_phase=t1[g],
                    bound_ms=bound_ms(flops, nbytes), samples_a_cluster=info["samples"])
    del system, cond, cond_cfg, batch, z_k, z_p
    torch.cuda.empty_cache()

    # ---- 34. kernel 5 at T = 1, 2, 10, both shapes; T2MSystem.sample at T = 2, 10
    src = "seeme_tpu_torch/csrc/ddim_tok.cu"
    rows = {}
    for text_dim, g in ((768, 7.5), (256, 1.0)):
        t = time.perf_counter()
        t2m_cfg = dataclasses.replace(T2MConfig(), text_encoded_dim=text_dim, guidance_scale=g)
        t2m = T2MSystem(t2m_cfg, torch.zeros(263), torch.ones(263), device=dev, seed=SEED)
        perturb_parameters_(t2m, torch.Generator().manual_seed(SEED + 5))
        tsd, tw = t2m.kernel_operands()
        text = torch.randn(B, 1, text_dim, generator=torch.Generator().manual_seed(SEED + 50))
        text = text.to(dev)
        c = (torch.cat([torch.zeros_like(text), text]) if g > 1 else text).contiguous()
        for T in (1, *MULTI_TOKENS):
            z0 = torch.randn(B, T, 256, generator=torch.Generator().manual_seed(SEED + 60 + T))
            args = (tsd, c, z0.to(dev), t2m.schedule, steps, t2m_cfg.num_layers, g)
            if T == 1:  # held to its plain version in phases 5 and 23
                t1[(text_dim, g)] = time_ms(lambda: dfu.ddim_fused_tok(*args, weights=tw), 3)
                continue
            z_k = dfu.ddim_fused_tok(*args, weights=tw)
            z_p, plain_ms = timed(lambda: dfu.ddim_fused_plain(*args, md_trans=False))
            err = compare(f"ddim_fused_tok T={T} text {text_dim} guidance {g}", z_k, z_p,
                          float(z_p.abs().max()), DDIM_RTOL)
            info = dfu.cluster_launch(False, B, 1, tw, g, tokens=T)
            print_launch(info)
            ms = time_ms(lambda: dfu.ddim_fused_tok(*args, weights=tw), 3)
            flops = tok_flops(tsd, t2m_cfg.num_layers, c.shape[0], 1, steps, T)
            nbytes = 4 * (sum(v.numel() for v in tsd.values()) + c.numel() + 2 * z0.numel()
                          + 2 * steps)
            phase(f"kernel ddim_tok T={T} (B={B}, text {text_dim}, guidance {g}, "
                  f"{info.get('samples', '-')} samples a cluster): {ms:.3f} ms (T=1 "
                  f"{t1[(text_dim, g)]:.3f} ms), plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms(flops, nbytes):.4f} ms ({bound_by(flops, nbytes)}), f32 bound "
                  f"{bound_f32_ms(flops, nbytes):.4f} ms", t)
            t = time.perf_counter()
            if text_dim == 768:
                rows[T] = kernel_row(f"ddim_tok_t{T}", src, err, ms, plain_ms, flops, nbytes,
                                     samples_a_cluster=info["samples"],
                                     t1_ms_same_phase=t1[(text_dim, g)])
                kernels.append(rows[T])
            else:
                rows[T]["preset_shape"] = dict(
                    ms=ms, plain_ms=plain_ms, max_abs_err=err, t1_ms_same_phase=t1[(text_dim, g)],
                    bound_ms=bound_ms(flops, nbytes), samples_a_cluster=info["samples"])
        del t2m, z_k, z_p
    for T in MULTI_TOKENS:
        t = time.perf_counter()
        t2m = T2MSystem(dataclasses.replace(T2MConfig(), latent_dim=(T, 256)), torch.zeros(263),
                        torch.ones(263), device=dev, seed=SEED)
        perturb_parameters_(t2m, torch.Generator().manual_seed(SEED + 5))
        text = torch.randn(B, 768, generator=torch.Generator().manual_seed(SEED + 51)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 52)
        t0 = time.perf_counter()
        feats, counts = counted(lambda: t2m.sample(text, generator=gen))
        wall = time.perf_counter() - t0
        require(tuple(feats.shape) == (B, 196, 263) and bool(torch.isfinite(feats).all()),
                f"t2m T={T} features {tuple(feats.shape)}")
        require(counts == {**none, f"ddim_tok_t{T}": 1}, f"t2m T={T} launch counts {counts}")
        launches[f"ddim_tok_t{T}"] = counts[f"ddim_tok_t{T}"]
        record(f"t2m_sampling_t{T}", counts)
        phase(f"T2MSystem.sample at latent [{T}, 256] (B={B}, guidance 7.5): launches {counts}, "
              f"{wall:.3f} s on the host clock", t)
        del t2m
    torch.cuda.empty_cache()

    # ---- 35. the multi-token EgoBody config from the shipped YAML
    t = time.perf_counter()
    two = ["model.latent_dim=[2,256]"]
    vae_yaml = os.path.join(configs, "config_vae_egobody.yaml")
    mld_yaml = os.path.join(configs, "config_mld_egobody.yaml")
    s1, counts = counted(lambda: train_main(["--cfg", vae_yaml, "--epochs", "2", "--out",
                                             os.path.join(work, "s1"), *two]))
    require(counts == none, f"T=2 stage 1 launch counts {counts}")
    record("train_stage1_t2", counts)
    first, last = s1.history[0]["means"]["total"], s1.history[-1]["means"]["total"]
    require(s1.system.cfg.latent_dim == (2, 256) and math.isfinite(last) and last < first,
            f"T=2 stage 1 epoch losses {first} -> {last}")
    phase(f"train stage 1 from --cfg config_vae_egobody.yaml {two[0]} (B={s1.batch_size}): "
          f"epoch means {first:.5f} -> {last:.5f}, launches {counts}", t)

    t = time.perf_counter()
    batch1 = to_torch(next(eval_batches(s1.datamodule, "test", B))[0], dev)
    stage1_through_kernel5(s1.system, batch1, counted, none, record, "egobody_stage1_sampling_t2")
    phase(f"the stage-1 model at latent [2, 256] (md_trans False) samples through kernel 5 "
          f"(B={B}): one launch, within {DDIM_RTOL:.0e} of the plain version", t)

    t = time.perf_counter()
    s2 = Trainer(parse_args(["--cfg", mld_yaml, "--epochs", "2", "--out",
                             os.path.join(work, "s2"), "--pretrained_vae", s1.checkpoints[-1],
                             *two]))
    _, counts = counted(s2.fill_feature_cache)
    require(counts == {**none, "pointnet_input_block": 5, "pointnet_split_block": 15},
            f"T=2 cache fill launch counts {counts}")

    def fixed_eval_loss():
        set_stage(s2.system, None)
        out = validate(s2.system, "diffusion", eval_batches(s2.datamodule, "val", 64))["total"]
        set_stage(s2.system, "diffusion")
        return out

    before = fixed_eval_loss()
    _, counts = counted(s2.fit)
    require(counts == none, f"T=2 stage 2 launch counts {counts}")
    record("train_stage2_t2", counts)
    after = fixed_eval_loss()
    first, last = s2.history[0]["means"]["total"], s2.history[-1]["means"]["total"]
    require(math.isfinite(last) and after < before,
            f"T=2 stage 2 fixed-draw val loss {before} -> {after}")
    phase(f"train stage 2 from --cfg config_mld_egobody.yaml {two[0]}: epoch means "
          f"{first:.5f} -> {last:.5f}, fixed-draw val {before:.5f} -> {after:.5f}", t)

    t = time.perf_counter()
    system = s2.system
    set_stage(system, None)  # eval mode, dropout off: the sampling default
    batch_np, n_valid = next(eval_batches(s2.datamodule, "test", B))
    batch = to_torch(batch_np, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)

    def ego_slice():
        feats = system.sample_from_cond(system.encode_conditioning(batch), generator=gen)
        out = system.eval_fk(batch, feats)
        metric = EgoMetric(split="test")
        mask = lengths_to_mask(batch["length"].long(), system.cfg.motion_length)
        metric.update(out["joints_rst"][:n_valid], out["joints_ref"][:n_valid],
                      out["quat_rst"][:n_valid], out["quat_ref"][:n_valid], mask[:n_valid])
        return feats, out, metric.compute()

    t0 = time.perf_counter()
    (feats, out, means), counts = counted(ego_slice)
    wall = time.perf_counter() - t0
    require(tuple(feats.shape) == (B, 60, system.cfg.nfeats), f"T=2 features {feats.shape}")
    require(all(bool(torch.isfinite(v).all()) for v in out.values()), "T=2 outputs not finite")
    require(all(math.isfinite(v) for v in means.values()), f"T=2 EgoMetric {means}")
    require(counts == {**none, "pointnet_input_block": 1, "pointnet_split_block": 3,
                       "ddim_md_t2": 1}, f"T=2 slice launch counts {counts}")
    launches["ddim_md_t2"] = counts["ddim_md_t2"]
    record("egobody_sampling_t2", counts)
    phase(f"EgoBody slice at latent [2, 256] (trained stage 2, B={B}): launches {counts}, "
          f"EgoMetric {json.dumps({k: round(v, 4) for k, v in means.items()})}, "
          f"{wall:.3f} s on the host clock", t)

    t = time.perf_counter()
    preset = preset_from_yaml(load_config(mld_yaml, overrides=parse_dotted_overrides(two)))
    _, cpu_system = build(preset, torch.device("cpu"))
    cpu_system.load_state_dict({k: v.cpu() for k, v in system.state_dict().items()})
    small = {k: v[:2].cpu() for k, v in batch.items()}
    small["scene"] = small["scene"][:, :512].contiguous()
    z_small = torch.randn(2, 2, 256, generator=torch.Generator().manual_seed(SEED + 54))
    ref = cpu_system.sample_from_cond(cpu_system.encode_conditioning(small), z_init=z_small)
    ref_j = cpu_system.eval_fk(small, ref)["joints_rst"]
    got = system.sample_from_cond(
        system.encode_conditioning({k: v.to(dev) for k, v in small.items()}),
        z_init=z_small.to(dev))
    got_j = system.eval_fk({k: v.to(dev) for k, v in small.items()}, got)["joints_rst"]
    compare("T=2 slice features, card vs CPU", got.cpu(), ref, float(ref.abs().max()), SLICE_RTOL)
    compare("T=2 slice joints, card vs CPU", got_j.cpu(), ref_j, float(ref_j.abs().max()),
            SLICE_RTOL)
    del cpu_system
    phase("T=2 slice reference: card path agrees with the CPU plain path (B=2, 512 points)", t)

    t = time.perf_counter()
    ten = load_config(mld_yaml, overrides=parse_dotted_overrides(["model.latent_dim=[10,256]"]))
    _, system10 = build(preset_from_yaml(ten), dev)
    perturb_parameters_(system10, torch.Generator().manual_seed(SEED + 1))
    cond = system10.encode_conditioning(batch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 55)
    t0 = time.perf_counter()
    feats, counts = counted(lambda: system10.sample_from_cond(cond, generator=gen))
    wall = time.perf_counter() - t0
    require(tuple(feats.shape) == (B, 60, system10.cfg.nfeats)
            and bool(torch.isfinite(feats).all()), "T=10 features")
    require(counts == {**none, "ddim_md_t10": 1}, f"T=10 sampling launch counts {counts}")
    launches["ddim_md_t10"] = counts["ddim_md_t10"]
    record("egobody_sampling_t10", counts)
    del system10
    phase(f"sample_from_cond at latent [10, 256] (B={B}): launches {counts}, {wall:.3f} s on the "
          "host clock", t)

    # ---- 36. the grid variant at T = 2 still launches ddim_fused
    t = time.perf_counter()
    grid_cfg = load_config(mld_yaml, overrides=parse_dotted_overrides(
        [*two, "model.fused_variant=grid"]))
    _, grid = build(preset_from_yaml(grid_cfg), dev)
    grid.load_state_dict(system.state_dict())
    cond = system.encode_conditioning(batch)
    z_init = torch.randn(B, 2, 256, generator=torch.Generator().manual_seed(SEED + 56)).to(dev)
    loop_feats = system.sample_from_cond(cond, z_init=z_init)
    grid_feats, counts = counted(lambda: grid.sample_from_cond(cond, z_init=z_init))
    require(grid.cfg.fused_variant == "grid" and counts == {**none, "ddim_md_t2": 1},
            f"T=2 grid variant launch counts {counts}")
    record("egobody_sampling_t2_grid_variant", counts)
    compare("T=2 grid vs loop variant features", grid_feats, loop_feats,
            float(loop_feats.abs().max()), SLICE_RTOL)
    del grid, system, s1, s2
    torch.cuda.empty_cache()
    phase(f"grid variant at latent [2, 256]: launches {counts} (ddim_fused, not the grid entry)",
          t)


def mld_phases(dev, counted, counters, record, kernels: list, launches: dict) -> None:
    """Phase 65: kernel 5 at MLD's published HumanML3D denoiser (9 layers,
    ff 1024, text 768, guidance 7.5, B = 64) at 4 heads, then at 2 heads
    with ff 512. Each: `T2MSystem.sample` with the launch counts reset just
    before takes exactly one `ddim_fused_tok` launch and never the
    `ddim_sample` loop; the kernel against `ddim_fused_plain(md_trans=False,
    num_heads=...)` on the same card inputs within DDIM_RTOL; the launch plan
    (13 clusters of 5 samples, one wave); ms, plain ms and bound. The 4-head
    shape is the `ddim_tok_mld` row of the kernels line, the 2-head one
    beside it."""
    import torch

    from seeme_tpu_torch.models import t2m as t2m_module
    from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import denoiser_fused as dfu

    none = {k: 0 for k in counters}
    B, L, text_dim, g = BATCH, 9, 768, 7.5
    src = "seeme_tpu_torch/csrc/ddim_tok.cu"
    row = None
    for heads, ff in ((4, 1024), (2, 512)):
        t = time.perf_counter()
        cfg = dataclasses.replace(T2MConfig(), num_layers=L, num_heads=heads, ff_size=ff,
                                  text_encoded_dim=text_dim, guidance_scale=g)
        t2m = T2MSystem(cfg, torch.zeros(263), torch.ones(263), device=dev, seed=SEED)
        perturb_parameters_(t2m, torch.Generator().manual_seed(SEED + 65))
        text = torch.randn(B, text_dim, generator=torch.Generator().manual_seed(SEED + 66))
        text = text.to(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 67)

        def no_loop(*args, **kwargs):
            raise SystemExit(f"chip_smoke: FAILED: MLD's widths at {heads} heads took the "
                             f"ddim_sample loop")

        t2m.sample(text, generator=gen)  # builds the kernel library and the operands
        torch.cuda.synchronize()
        loop, t2m_module.ddim_sample = t2m_module.ddim_sample, no_loop
        try:
            t0 = time.perf_counter()
            feats, counts = counted(lambda: t2m.sample(text, generator=gen))
            wall = time.perf_counter() - t0
        finally:
            t2m_module.ddim_sample = loop
        require(tuple(feats.shape) == (B, cfg.max_len, 263) and bool(torch.isfinite(feats).all()),
                f"MLD widths, {heads} heads: features {tuple(feats.shape)}")
        require(counts == {**none, "ddim_tok_t1": 1},
                f"MLD widths, {heads} heads: launch counts {counts}")
        record(f"t2m_sampling_mld_h{heads}", counts)

        tsd, tw = t2m.kernel_operands()
        require(tw.num_heads == heads and tw.ff == ff, f"kernel weights {tw.num_heads} / {tw.ff}")
        c = torch.cat([torch.zeros_like(text), text])[:, None].contiguous()
        z0 = torch.randn(B, 1, 256, generator=torch.Generator().manual_seed(SEED + 68)).to(dev)
        steps = cfg.num_inference_timesteps
        args = (tsd, c, z0, t2m.schedule, steps, L, g)
        z_k = dfu.ddim_fused_tok(*args, weights=tw)
        z_p, plain_ms = timed(lambda: dfu.ddim_fused_plain(*args, md_trans=False,
                                                           num_heads=heads))
        err = compare(f"ddim_fused_tok at MLD's widths, {heads} heads, ff {ff}", z_k, z_p,
                      float(z_p.abs().max()), DDIM_RTOL)
        info = dfu.cluster_launch(False, B, 1, tw, g)
        print_launch(info)
        clusters = info["grid"] // info["cluster"]
        require(info["samples"] == 5 and clusters == 13 <= info["active_clusters"],
                f"MLD widths, {heads} heads: launch plan {info}")
        ms = time_ms(lambda: dfu.ddim_fused_tok(*args, weights=tw), 3)
        flops = tok_flops(tsd, L, c.shape[0], 1, steps)
        nbytes = 4 * (sum(v.numel() for v in tsd.values()) + c.numel() + 2 * z0.numel()
                      + 2 * steps)
        phase(f"kernel ddim_tok at MLD's widths (B={B}, {L} layers, {heads} heads, ff {ff}, text "
              f"{text_dim}, guidance {g}, {info['samples']} samples a cluster, {clusters} "
              f"clusters, {info['smem_bytes']} B a CTA): {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms(flops, nbytes):.4f} ms ({bound_by(flops, nbytes)}), f32 bound "
              f"{bound_f32_ms(flops, nbytes):.4f} ms; T2MSystem.sample one launch, no loop, "
              f"{wall:.3f} s on the host clock", t)
        plan = dict(samples_a_cluster=info["samples"], clusters=clusters,
                    active_clusters=info["active_clusters"], smem_bytes=info["smem_bytes"])
        if row is None:
            row = kernel_row("ddim_tok_mld", src, err, ms, plain_ms, flops, nbytes,
                             counter="ddim_tok_t1", layers=L, heads=heads, ff=ff, **plan)
            kernels.append(row)
            launches["ddim_tok_mld"] = counts["ddim_tok_t1"]
        else:
            row[f"heads{heads}_ff{ff}"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                               bound_ms=bound_ms(flops, nbytes), **plan)
        del t2m, z_k, z_p
        torch.cuda.empty_cache()


def entry_phases(dev, counted, counters, record, work: str) -> None:
    """Phases 37-40: the root entry points through `--cfg`. 37: `demo`
    with `config_mld_egobody.yaml --mesh` (kernels 1/3 and kernel 3 once);
    38: `demo` with `config_mld_humanml3d.yaml` and an `--example` file the
    phase writes (kernel 5 once), then `--task random_sampling` (nothing),
    and with `config_mld_humanact12.yaml --actions` (kernel 5 once); 39:
    `scene_encoder` (kernels 1/3 at H = 256) against the plain twin; 40:
    `fit` over the ego demo's first sample."""
    import numpy as np
    import torch

    from seeme_tpu_torch import demo, fit, scene_encoder
    from seeme_tpu_torch.nn.init import init_parameters_
    from seeme_tpu_torch.nn.pointnet import ResnetPointnet
    from seeme_tpu_torch.ops.pointnet_fused import FusedPointnet

    none = {k: 0 for k in counters}
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

    def check_files(folder, names):
        got = sorted(os.listdir(folder))
        require(got == sorted(names), f"{folder}: wrote {got}, not {sorted(names)}")
        for n in names:
            if n.endswith(".npy"):
                require(bool(np.isfinite(np.load(os.path.join(folder, n))).all()), f"{n} not finite")

    # ---- 37. the ego demo with meshes
    t = time.perf_counter()
    ego_dir = os.path.join(work, "demo_ego")
    saved, counts = counted(lambda: demo.main([
        "--cfg", os.path.join(configs, "config_mld_egobody.yaml"), "--mesh", "--out", ego_dir]))
    require(counts == {**none, "pointnet_input_block": 1, "pointnet_split_block": 3,
                       "ddim_md_t1": 1}, f"ego demo launch counts {counts}")
    record("demo_egobody", counts)
    check_files(ego_dir, ["faces.npy"] + [f"{p}_{i}{q}.npy" for i in range(4)
                                          for p, q in (("sample", ""), ("gt", ""),
                                                       ("sample", "_mesh"))])
    mesh = np.load(os.path.join(ego_dir, "sample_0_mesh.npy"))
    require(mesh.shape == (60, 6890, 3), f"mesh {mesh.shape}")
    phase(f"demo --cfg config_mld_egobody.yaml --mesh: {len(saved)} samples, meshes "
          f"{mesh.shape}, launches {counts}", t)

    # ---- 38. the text and action demos
    t = time.perf_counter()
    example = os.path.join(work, "captions.txt")
    with open(example, "w") as f:
        f.write("120 a person walks forward and turns around\n"
                "60 someone jumps up twice\n"
                "a person waves with the right hand\n")
    text_yaml = os.path.join(configs, "config_mld_humanml3d.yaml")
    text_dir = os.path.join(work, "demo_text")
    saved, counts = counted(lambda: demo.main(["--cfg", text_yaml, "--example", example,
                                               "--out", text_dir]))
    require(counts == {**none, "ddim_tok_t1": 1}, f"text demo launch counts {counts}")
    record("demo_text_example", counts)
    check_files(text_dir, ["captions.txt", "sample_0.npy", "sample_1.npy", "sample_2.npy"])
    shapes = [np.load(p).shape for p in saved]
    require([s[0] for s in shapes] == [120, 60, 196], f"text demo lengths {shapes}")
    rand_dir = os.path.join(work, "demo_random")
    saved, counts = counted(lambda: demo.main(["--cfg", text_yaml, "--task", "random_sampling",
                                               "--out", rand_dir]))
    require(counts == none, f"random-sampling demo launch counts {counts}")
    check_files(rand_dir, [f"random_{i}.npy" for i in range(4)])
    action_dir = os.path.join(work, "demo_action")
    saved, counts_a = counted(lambda: demo.main([
        "--cfg", os.path.join(configs, "config_mld_humanact12.yaml"), "--actions", "0,3,7",
        "--out", action_dir]))
    require(counts_a == {**none, "ddim_tok_t1": 1}, f"action demo launch counts {counts_a}")
    record("demo_action", counts_a)
    check_files(action_dir, ["action_0.npy", "action_3.npy", "action_7.npy"])
    phase(f"demo text --example: joints {shapes}, launches ddim_tok_t1 1; --task "
          f"random_sampling: none; action --actions 0,3,7: "
          f"{np.load(saved[0]).shape}, launches {counts_a}", t)

    # ---- 39. the scene encoder
    t = time.perf_counter()
    emb, counts = counted(lambda: scene_encoder.main([]))
    require(counts == {**none, "pointnet_input_block_h256": 1, "pointnet_split_block_h256": 3},
            f"scene_encoder launch counts {counts}")
    record("scene_encoder", counts)
    enc = ResnetPointnet(out_dim=512, hidden_dim=256)
    init_parameters_(enc, torch.Generator().manual_seed(0))
    pcd = torch.as_tensor(np.random.RandomState(0).randn(1, 20000, 3).astype(np.float32))
    with torch.no_grad():
        plain = FusedPointnet()(enc.requires_grad_(False).eval(), pcd)
    require(tuple(emb.shape) == (1, 512), f"scene embedding {tuple(emb.shape)}")
    compare("scene_encoder embedding, kernels vs plain twin", emb.cpu(), plain,
            float(plain.abs().max()), POINTNET_RTOL)
    phase(f"scene_encoder (20000 points, H=256): shape {tuple(emb.shape)}, norm "
          f"{float(emb.norm()):.3f}, launches {counts}", t)

    # ---- 40. fitting the ego demo's first sample
    t = time.perf_counter()
    t0 = time.perf_counter()
    out, counts = counted(lambda: fit.main([
        "--joints", os.path.join(ego_dir, "sample_0.npy"), "--steps", "100",
        "--gmm", os.path.join(work, "no_gmm"), "--out", os.path.join(work, "fit.npz"),
        "--save_mesh", os.path.join(work, "fit_mesh.npy")]))
    wall = time.perf_counter() - t0
    losses = out["losses"]
    require(counts == none, f"fit launch counts {counts}")
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"fit losses {losses[0]} -> {losses[-1]}")
    require(all(bool(torch.isfinite(v).all()) for v in out["params"].values()), "fit params")
    phase(f"fit (60 frames, 100 Adam steps on the card): loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, terms {json.dumps({k: round(v, 5) for k, v in out['terms'].items()})}"
          f", {wall:.3f} s on the host clock", t)


def smpl_file_phases(dev, counted, counters, record, work: str) -> None:
    """Phases 41-42: the SMPL model file. 41: a 6890-vertex body written in
    the MPI layout (`core/smpl.py::save_smpl`: chumpy-typed fields through a
    stand-in module registered only while pickling, a csc `J_regressor`,
    (V, 3, 207) pose blend shapes) and as the `.npz` cache, read back on the
    card bitwise; the test CLI with `--cfg config_mld_egobody.yaml
    model.smpl_path=<pkl>` at B=64 (expected: 1 / 3 / kernel 3 once, the
    file's body in the system), then that slice card vs CPU at B=2 with 512
    points. 42: `fit --smpl_path` and the a2m test CLI with the file."""
    import numpy as np
    import torch

    from seeme_tpu_torch import fit
    from seeme_tpu_torch.config.presets import build
    from seeme_tpu_torch.core import smpl as psmpl
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.test.__main__ import Evaluator
    from seeme_tpu_torch.test.__main__ import main as test_main
    from seeme_tpu_torch.test.__main__ import parse_args as test_args

    none = {k: 0 for k in counters}
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

    # ---- 41. the file, read on the card, and the EgoBody --cfg slice on its body
    t = time.perf_counter()
    written = psmpl.synthetic_smpl(n_verts=6890, seed=SEED)
    pkl, npz = os.path.join(work, "SMPL_NEUTRAL.pkl"), os.path.join(work, "SMPL_NEUTRAL.npz")
    psmpl.save_smpl(written, pkl)
    psmpl.save_smpl(written, npz)
    for path in (pkl, npz):
        body = psmpl.load_smpl(path, dev)
        for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                     "parents"):
            got = getattr(body, name)
            require(got.is_cuda and torch.equal(got.cpu(), getattr(written, name)),
                    f"{os.path.basename(path)}: {name} is not the written array")
        require(np.array_equal(body.extra_joint_ids.cpu().numpy(), psmpl.EXTRA_JOINT_VERTEX_IDS)
                and np.array_equal(body.faces, written.faces),
                f"{os.path.basename(path)}: extra joints or faces")
    ev = Evaluator(test_args(["--cfg", os.path.join(configs, "config_mld_egobody.yaml"),
                              "--out", os.path.join(work, "test_smpl_file"),
                              f"model.smpl_path={pkl}"]))
    require(ev.preset.smpl_path == pkl
            and torch.equal(ev.system.smpl.v_template.cpu(), written.v_template),
            "the --cfg system does not carry the file's body")
    result, counts = counted(ev.run)
    require(counts == {**none, "pointnet_input_block": 1, "pointnet_split_block": 3,
                       "ddim_md_t1": 1}, f"EgoBody --cfg test CLI with the SMPL file {counts}")
    record("egobody_test_cli_smpl_file", counts)
    stats = result["stats"]
    require(stats and all(math.isfinite(x) for v in stats.values() for x in v.values()),
            f"EgoBody test CLI statistics {stats}")
    system = ev.system
    _, cpu_system = build(ev.preset, torch.device("cpu"))
    cpu_system.load_state_dict({k: v.cpu() for k, v in system.state_dict().items()})
    small = to_torch(next(ev.datamodule.batches("test", 2, shuffle=False)), "cpu")
    small["scene"] = small["scene"][:, :512].contiguous()
    z_small = torch.randn(2, 1, system.cfg.latent_dim[-1],
                          generator=torch.Generator().manual_seed(SEED + 41))
    with torch.no_grad():
        ref = cpu_system.sample_from_cond(cpu_system.encode_conditioning(small), z_init=z_small)
        ref_out = cpu_system.eval_fk(small, ref)
        on = {k: v.to(dev) for k, v in small.items()}
        got = system.sample_from_cond(system.encode_conditioning(on), z_init=z_small.to(dev))
        got_out = system.eval_fk(on, got)
    compare("SMPL-file slice features, card vs CPU", got.cpu(), ref, float(ref.abs().max()),
            SLICE_RTOL)
    compare("SMPL-file slice joints, card vs CPU", got_out["joints_rst"].cpu(),
            ref_out["joints_rst"], float(ref_out["joints_rst"].abs().max()), SLICE_RTOL)
    del ev, system, cpu_system
    torch.cuda.empty_cache()
    phase(f"SMPL file: 6890-vertex .pkl ({os.path.getsize(pkl)} B) and .npz read on the card "
          f"bitwise as written; test --cfg config_mld_egobody.yaml model.smpl_path=<pkl> B={BATCH}: "
          f"launches {counts}, metric means "
          f"{json.dumps({k: round(v['mean'], 4) for k, v in sorted(stats.items())})}; card vs "
          f"CPU at B=2 agrees", t)

    # ---- 42. fit and the a2m test CLI on the file
    t = time.perf_counter()
    body = psmpl.load_smpl(pkl, dev)
    g = torch.Generator().manual_seed(SEED + 42)
    with torch.no_grad():
        target = psmpl.smpl_joints24(body, (0.5 * torch.randn(60, 10, generator=g)).to(dev),
                                     (0.2 * torch.randn(60, 69, generator=g)).to(dev),
                                     (0.2 * torch.randn(60, 3, generator=g)).to(dev))
    np.save(os.path.join(work, "smpl_joints.npy"), target.cpu().numpy())
    out, counts = counted(lambda: fit.main([
        "--joints", os.path.join(work, "smpl_joints.npy"), "--steps", "50", "--smpl_path", pkl,
        "--gmm", os.path.join(work, "no_gmm"), "--out", os.path.join(work, "fit_file.npz")]))
    losses = out["losses"]
    require(counts == none and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"fit --smpl_path: launches {counts}, losses {losses[0]} -> {losses[-1]}")
    result, counts_a = counted(lambda: test_main([
        "--cfg", os.path.join(configs, "config_mld_humanact12.yaml"), "--out",
        os.path.join(work, "test_a2m_smpl_file"), f"model.smpl_path={pkl}"]))
    require(counts_a == {**none, "ddim_tok_t1": 1}, f"a2m --cfg test CLI with the file {counts_a}")
    record("a2m_test_cli_smpl_file", counts_a)
    require(all(math.isfinite(x) for v in result["stats"].values() for x in v.values()),
            f"a2m test CLI statistics {result['stats']}")
    phase(f"fit --smpl_path <pkl> (60 frames, 50 steps): loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; test --cfg config_mld_humanact12.yaml model.smpl_path=<pkl>: "
          f"launches {counts_a}, metric means "
          f"{json.dumps({k: round(v['mean'], 4) for k, v in sorted(result['stats'].items())})}", t)


def evaluator_phases(dev, counted, counters, record, work: str) -> None:
    """Phases 43-45: `python -m seeme_tpu_torch.tools.train_evaluator` on the
    card, each trained file reloaded by the test CLI's loader (its outputs
    on a fixed batch bitwise the trainer's) and then used by the test CLI
    through `--cfg` (expected: kernel 5 once, "loaded evaluator" in its
    log). 43: the HumanAct12 GRU, 12 epochs, final val accuracy > 0.3; 44:
    the UESTC ST-GCN, 3 epochs, its epoch loss falling; 45: the HumanML3D
    trio with `--debug`, EVAL_T2M_EPOCHS epochs, test R@1(32) > 0.15. Each
    reports ms a step (`StepTimer`, synchronised) and the device idle share
    over 5 more steps."""
    import numpy as np
    import torch

    from seeme_tpu_torch.eval.t2m_evaluator import T2MEvaluator
    from seeme_tpu_torch.test.__main__ import action_evaluator
    from seeme_tpu_torch.test.__main__ import main as test_main
    from seeme_tpu_torch.tools import train_evaluator

    none = {k: 0 for k in counters}
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

    def reloaded_outputs(tr, path):
        """The trainer's outputs and the loader's on the val split's first 16."""
        x = tr.inputs(next(tr.dm.batches("val", 16, shuffle=False)))
        with torch.no_grad():
            want = tr.outputs(x)
            if tr.kind == "t2m":
                ev = T2MEvaluator(nfeats=tr.dm.nfeats, ckpt=path, device=dev)
                mov = ev.movement_encoder(x["feats"][..., :-4])
                got = (ev.text_encoder(x["words"], x["pos"], x["cap_lens"]),
                       ev.motion_encoder(mov, x["length"] // ev.unit_len))
                return list(got), list(want)
            clf = action_evaluator(tr.name, tr.dm.num_classes, SEED, dev, checkpoint=path)
            return [clf(tr.classifier_input(x["motion"]), x["length"])[0]], [want]

    def idle_share(tr):
        tr.module.requires_grad_(True)
        tr.train_mode(True)
        x = tr.inputs(next(tr.train_batches(0)))
        busy, wall, _ = profile_busy(lambda: [tr.step(x) for _ in range(5)])
        return 1 - busy / wall

    def run(label, yaml, args, key, check):
        t = time.perf_counter()
        path = os.path.join(work, f"{label}.tar")
        tr, counts = counted(lambda: train_evaluator.main(
            ["--cfg", os.path.join(configs, yaml), "--out", path] + args))
        require(counts == none, f"{label} training launched {counts}")
        losses = [r["loss"] for r in tr.history]
        require(all(math.isfinite(v) for v in losses), f"{label} losses {losses}")
        check(tr, losses)
        got, want = reloaded_outputs(tr, path)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"{label}: the reloaded file's outputs are not the trainer's")
        out = os.path.join(work, f"test_{label}")
        result, counts = counted(lambda: test_main([
            "--cfg", os.path.join(configs, yaml), "--out", out, f"TEST.{key}={path}"]))
        require(counts == {**none, "ddim_tok_t1": 1}, f"{label} test CLI launch counts {counts}")
        record(f"test_cli_trained_{label}", counts)
        with open(os.path.join(out, "test_log.txt")) as f:
            require("loaded evaluator" in f.read(), f"{label}: the test CLI did not load it")
        require(all(math.isfinite(x) for v in result["stats"].values() for x in v.values()),
                f"{label} test CLI statistics {result['stats']}")
        ms = sorted(1e3 * x for x in tr.timer.times[1:])
        idle = idle_share(tr)
        final = ("R@1(32) on the test split" if tr.kind == "t2m"
                 else f"accuracy on the {tr.metric_split} split")
        phase(f"train_evaluator {label} ({tr.kind}, {len(tr.timer.times)} steps of "
              f"{tr.args.batch_size}): loss {losses[0]:.4f} -> {losses[-1]:.4f}, final "
              f"{final} {tr.final_metric:.3f}, {ms[len(ms) // 2]:.3f} ms a step (median, min "
              f"{ms[0]:.3f}, max {ms[-1]:.3f}), device idle share {idle:.3f} over 5 more steps; "
              f"reloaded bitwise; test CLI with it: launches {counts}, means "
              f"{json.dumps({k: round(v['mean'], 4) for k, v in sorted(result['stats'].items())})}",
              t)

    def gru_check(tr, losses):
        require(tr.final_metric > 0.3, f"GRU final val accuracy {tr.final_metric}")

    def falls(tr, losses):
        require(losses[-1] < losses[0], f"ST-GCN epoch losses {losses}")

    def r1_check(tr, losses):
        require(tr.final_metric > 0.15, f"TM2T test R@1(32) {tr.final_metric}")

    run("humanact12_gru", "config_mld_humanact12.yaml", ["--epochs", "12"],
        "EVALUATOR_CHECKPOINT", gru_check)
    run("uestc_stgcn", "config_mld_uestc.yaml", ["--epochs", "3"], "EVALUATOR_CHECKPOINT",
        falls)
    run("humanml3d_tm2t", "config_mld_humanml3d.yaml",
        ["--debug", "--epochs", str(EVAL_T2M_EPOCHS)], "T2M_EVALUATOR_DIR", r1_check)


def feature_phases(dev) -> None:
    """Phase 46: the HumanML3D / KIT feature pipeline on the card.
    `preprocess_humanml` over seeded random-walk joints (22 and 21 joints,
    196 frames, two clips each) on the card and on the CPU: features within
    FEATURE_RTOL of max |feat|, recovered joints within 1e-5; the RIC
    recovery of the card's features against its canonical joints (5e-3, the
    CPU test's bound); RIFKE and APE / AVE card vs CPU (1e-5)."""
    import numpy as np
    import torch

    from seeme_tpu_torch.core import rifke
    from seeme_tpu_torch.core.motion_process import SPECS, forward_kinematics, process_file
    from seeme_tpu_torch.core.ric import recover_from_ric
    from seeme_tpu_torch.eval.ape_ave import ApeAveMetrics
    from seeme_tpu_torch.tools import preprocess_humanml

    t = time.perf_counter()
    base = tempfile.mkdtemp(prefix="seeme_features_")
    worst = {}
    try:
        for name in ("humanml3d", "kit"):
            spec, rng = SPECS[name], np.random.RandomState(SEED + 46)
            src = os.path.join(base, name, "joints")
            os.makedirs(src)
            for i in range(2):  # FK of small drifting rotations, plus a walking root
                aa = np.cumsum(rng.randn(196, spec.joints_num, 3) * 0.02, axis=0)
                angle = np.linalg.norm(aa, axis=-1, keepdims=True) + 1e-9
                quat = np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * aa / angle], -1)
                root = np.cumsum(rng.randn(196, 3) * 0.01, axis=0) + [0.0, 0.9, 0.0]
                offsets = spec.raw_offsets * (0.2 + 0.2 * rng.rand(spec.joints_num, 1))
                joints = forward_kinematics(*(torch.as_tensor(a) for a in (quat, root, offsets)),
                                            spec)
                np.save(os.path.join(src, f"{i:06d}.npy"), joints.numpy())
            outs = {}
            for where, extra in (("card", []), ("cpu", ["--cpu"])):
                d = os.path.join(base, name, where)
                t_run = time.perf_counter()
                result = preprocess_humanml.main([
                    "--dataset", name, "--joints_dir", src, "--out_vecs", os.path.join(d, "vecs"),
                    "--out_joints", os.path.join(d, "joints"), "--stats", base] + extra)
                require(len(result["processed"]) == 2, f"{name} preprocess {where}: {result}")
                outs[where] = (d, time.perf_counter() - t_run)
            for f in sorted(os.listdir(os.path.join(outs["cpu"][0], "vecs"))):
                card, cpu = (np.load(os.path.join(outs[w][0], "vecs", f)) for w in ("card", "cpu"))
                require(card.shape == (195, 263 if name == "humanml3d" else 251),
                        f"{name} features {card.shape}")
                worst[f"{name} features"] = compare(
                    f"{name} {f} features, card vs CPU", torch.as_tensor(card),
                    torch.as_tensor(cpu), float(np.abs(cpu).max()), FEATURE_RTOL)
                card_j, cpu_j = (np.load(os.path.join(outs[w][0], "joints", f))
                                 for w in ("card", "cpu"))
                worst[f"{name} recovered joints"] = compare(
                    f"{name} {f} recovered joints, card vs CPU", torch.as_tensor(card_j),
                    torch.as_tensor(cpu_j), float(np.abs(cpu_j).max()), 1e-5)
            raw = torch.as_tensor(np.load(os.path.join(src, "000000.npy")), device=dev)
            data, glob, _, _ = process_file(raw, spec)
            rec = recover_from_ric(data.float(), spec.joints_num)
            gap = float((rec.double() - glob[:-1]).abs().max())
            require(gap < 5e-3, f"{name}: RIC recovery of the card's features off by {gap}")
            worst[f"{name} RIC recovery (abs)"] = gap
            worst[f"{name} ms on card / cpu"] = [round(1e3 * outs[w][1], 1) for w in ("card", "cpu")]
        joints = torch.as_tensor(np.stack([np.load(os.path.join(base, "humanml3d", "joints", f))
                                           for f in ("000000.npy", "000001.npy")]),
                                 dtype=torch.float32)
        feats_cpu = rifke.joints_to_rifke(joints)
        feats = rifke.joints_to_rifke(joints.to(dev))
        scale = float(feats_cpu.abs().max())
        worst["rifke"] = compare("RIFKE features, card vs CPU", feats.cpu(), feats_cpu, scale, 1e-5)
        back_cpu = rifke.rifke_to_joints(feats_cpu)
        worst["rifke inverse"] = compare("RIFKE inverse, card vs CPU",
                                         rifke.rifke_to_joints(feats).cpu(), back_cpu,
                                         float(back_cpu.abs().max()), 1e-5)
        noisy = joints + 0.05 * torch.randn(joints.shape, generator=torch.Generator().manual_seed(7))
        lengths = np.array([196, 150])
        metrics = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            m = ApeAveMetrics()
            m.update(noisy.to(device), joints.to(device), lengths)
            metrics[where] = m.compute()
        for k, v in metrics["cpu"].items():
            require(abs(metrics["card"][k] - v) <= 1e-5 * max(abs(v), 1e-12),
                    f"{k}: card {metrics['card'][k]} vs CPU {v}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    phase(f"feature pipeline: preprocess_humanml card vs CPU, RIC recovery, RIFKE and APE/AVE "
          f"agree; max abs gaps and times {json.dumps(worst)}; APE/AVE "
          f"{json.dumps({k: round(v, 5) for k, v in sorted(metrics['card'].items())})}", t)


def prefetch_phases(dev, counted, counters, record, work: str) -> None:
    """Phase 47: stage-2 EgoBody training at B=64 with the raw 20 000-point
    scene in every batch (no feature cache, ~18 MB a batch) through
    `run_epoch`, whose batches come through `data/prefetch.py`: every
    prefetched batch bitwise its host batch; after one warm-up step each,
    the terms of PREFETCH_STEPS steps against a loop of
    `train_step(to_torch(b))` on a twin trainer with the same weights,
    generators and batches (1e-6 relative), in two halves run prefetched,
    synchronous, synchronous, prefetched; the host clock a step and the
    device idle share of both loops, and one batch's pageable copy and
    pinned staged copy alone (a record, not a claim)."""
    import itertools

    import numpy as np
    import torch

    from seeme_tpu_torch.data.prefetch import prefetch_to_device
    from seeme_tpu_torch.data.synthetic import to_torch
    from seeme_tpu_torch.train.__main__ import Trainer, parse_args
    from seeme_tpu_torch.train.loop import run_epoch, train_step

    t = time.perf_counter()
    none = {k: 0 for k in counters}
    argv = ["--preset", "mld_egobody", "--epochs", "1", "train.feature_cache=False",
            *HOST_ROUTE, "--out", os.path.join(work, "prefetch")]
    a, b = Trainer(parse_args(argv)), Trainer(parse_args(argv))
    b.system.load_state_dict(a.system.state_dict())
    host = list(itertools.islice(itertools.chain.from_iterable(
        a.train_batches(epoch) for epoch in itertools.count()), PREFETCH_STEPS + 1))
    mb = sum(v.nbytes for v in host[0].values() if isinstance(v, np.ndarray)) / 1e6
    require(host[0]["scene"].shape == (BATCH, HMR_POINTS, 3), f"scene {host[0]['scene'].shape}")
    for h, d in zip(host, prefetch_to_device(iter(host), dev)):
        for k, v in h.items():
            require(d[k].is_cuda and torch.equal(d[k].cpu(), torch.as_tensor(v)),
                    f"prefetched {k} is not its host batch")

    def copy_ms(fn, n=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    pageable = copy_ms(lambda: to_torch(host[0], dev))
    staged = copy_ms(lambda: next(prefetch_to_device(iter(host[:1]), dev)))
    for tr in (a, b):  # one warm-up step each, on the same batch and draws
        torch.manual_seed(SEED + 47)
        train_step(tr.system, tr.stage, tr.optimizer, tr.schedule, 0, to_torch(host[0], dev),
                   tr.generator)
    half = PREFETCH_STEPS // 2
    halves = (host[1:1 + half], host[1 + half:])
    steps_a, synced, runs = [], [], {"prefetched": [], "synchronous": []}

    def prefetched(k):
        def run():
            steps_a.extend(run_epoch(a.system, a.stage, a.optimizer, a.schedule, 1 + k * half,
                                     iter(halves[k]), a.generator)[2])
        return run

    def synchronous(k):
        def run():
            for i, h in enumerate(halves[k], 1 + k * half):
                synced.append(train_step(b.system, b.stage, b.optimizer, b.schedule, i,
                                         to_torch(h, dev), b.generator))
        return run

    all_counts = []
    # prefetched, synchronous, synchronous, prefetched; each half's dropout
    # draws (torch's default generator) seeded alike for both loops
    for k, name in ((0, "prefetched"), (0, "synchronous"), (1, "synchronous"),
                    (1, "prefetched")):
        torch.manual_seed(SEED + 48 + k)
        run = prefetched(k) if name == "prefetched" else synchronous(k)
        (busy, wall, _), counts = counted(lambda: profile_busy(run))
        runs[name].append((busy, wall))
        if name == "prefetched":
            all_counts.append(counts)
    counts = {k: sum(c[k] for c in all_counts) for k in all_counts[0]}
    require(counts == {**none, "pointnet_input_block": PREFETCH_STEPS,
                       "pointnet_split_block": 3 * PREFETCH_STEPS},
            f"prefetched stage-2 epoch launch counts {counts}")
    record("prefetch_stage2_steps", counts)
    for i, (x, y) in enumerate(zip(steps_a, synced)):
        for k in y:
            require(abs(x[k] - y[k]) <= 1e-6 * max(abs(y[k]), 1e-12),
                    f"step {i} {k}: prefetched {x[k]} vs synchronous {y[k]}")
    require(len(steps_a) == len(synced) == PREFETCH_STEPS, "prefetch steps missing")
    (busy_a, wall_a), (busy_b, wall_b) = (
        [sum(x) for x in zip(*runs[name])] for name in ("prefetched", "synchronous"))
    ms_a = [round(w / half, 3) for _, w in runs["prefetched"]]
    ms_b = [round(w / half, 3) for _, w in runs["synchronous"]]
    n = PREFETCH_STEPS
    phase(f"prefetch: stage 2 (mld_egobody, no cache) B={BATCH}, {HMR_POINTS} points, "
          f"{mb:.1f} MB a batch, {n} steps after a warm-up, in halves run prefetched, "
          f"synchronous, synchronous, prefetched: every prefetched batch bitwise its host batch, "
          f"terms within 1e-6 of the synchronous loop's; prefetched {wall_a / n:.3f} ms a step "
          f"on the host clock (halves {ms_a}), device idle share {1 - busy_a / wall_a:.3f}; "
          f"synchronous {wall_b / n:.3f} ms a step (halves {ms_b}), idle share "
          f"{1 - busy_b / wall_b:.3f}; one batch alone: pageable copy {pageable:.3f} ms, pinned "
          f"staging and copy {staged:.3f} ms; launches {counts}", t)

def forward_counter(module) -> list:
    """A list that grows by one at each forward of `module`."""
    calls = []
    module.register_forward_hook(lambda *_: calls.append(1))
    return calls


def timed_image_features(system, events: list) -> None:
    """Wrap the system's `image_features` with CUDA events, kept in `events`."""
    import torch

    inner = system.image_features

    def timed(image):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(image)
        end.record()
        events.append((start, end))
        return out

    system.image_features = timed


def randomize_batch_stats_(module, generator) -> None:
    """Running statistics away from (0, 1), drawn on the CPU, so both
    devices get the same."""
    import torch

    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "running_var"):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=generator) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=generator) + 0.5)


@contextlib.contextmanager
def relu_decisions(model, masks: list, record: bool):
    """Within: each `torch.relu` of a forward (and so `F.relu`, `nn.ReLU`)
    appends its decisions x > 0 to `masks` (`record`), or takes them from
    `masks` in the same order and returns x * mask, so that a decision
    within rounding of 0 goes the same way in a CPU step as it went in the
    card's. The scene encoder's gradients come on both devices from its
    eager forward recomputed in backward (`ops/pointnet_fused.py`): there
    the ReLUs are replayed too, and so is each max-pool's choice of point
    (a near tie picks another point on the other device and routes the
    pooled gradient there), as the mask of the points that took the max,
    replayed as their mean, whose gradient splits over them as `amax`'s
    does over a tie. The encoder's forward through the kernels calls no
    relu, and the rest of backward none that counts."""
    import torch

    from seeme_tpu_torch.nn.pointnet import ResnetPointnet

    relu, grad, backward = torch.relu, torch.autograd.grad, torch.Tensor.backward
    amax, eager = torch.Tensor.amax, ResnetPointnet.forward
    encode_scene, on, in_scene, taken = model.encode_scene, [True], [False], iter(masks)

    def replayed(kind, x):
        got, mask = next(taken, (None, None))
        require(got == kind and mask is not None and mask.shape == x.shape,
                f"decisions out of step: {got} {None if mask is None else tuple(mask.shape)} "
                f"recorded, {kind} {tuple(x.shape)} here")
        return mask.to(x)

    def decided(x):
        if not (on[0] or in_scene[0]):
            return relu(x)
        if record:
            masks.append(("relu", (x > 0).cpu()))
            return relu(x)
        return x * replayed("relu", x)

    def pooled(x, dim, keepdim=False):
        if not in_scene[0]:
            return amax(x, dim, keepdim)
        if record:
            top = amax(x, dim, True)
            masks.append(("amax", (x == top).cpu()))
            return top if keepdim else top.squeeze(dim)
        mask = replayed("amax", x)
        top = (x * mask).sum(dim, keepdim=True) / mask.sum(dim, keepdim=True)
        return top if keepdim else top.squeeze(dim)

    def recomputed(self, points):
        in_scene[0] = True
        try:
            return eager(self, points)
        finally:
            in_scene[0] = False

    def off(fn):
        def wrapped(*a, **kw):
            on[0] = False
            try:
                return fn(*a, **kw)
            finally:
                on[0] = True
        return wrapped

    torch.relu, torch.autograd.grad, torch.Tensor.backward = decided, off(grad), off(backward)
    torch.Tensor.amax, ResnetPointnet.forward = pooled, recomputed
    model.encode_scene = off(encode_scene)
    try:
        yield
    finally:
        torch.relu, torch.autograd.grad, torch.Tensor.backward = relu, grad, backward
        torch.Tensor.amax, ResnetPointnet.forward = amax, eager
        model.encode_scene = encode_scene
    require(record or next(taken, None) is None, "relu decisions left over")


def compare_step(stage, cpu, card, loss_cpu, loss_card, lr: float) -> None:
    """One train step's loss, gradients and updated parameters, card vs CPU.
    A first AdamW step moves each element by lr * g / (|g| + eps), about
    lr * sign(g), so the updated parameters are compared where the
    gradient's sign is settled (|g| above 1e-6 and above 10 times its card
    vs CPU gap), within 2e-6; elsewhere only Adam's own bound of 2 lr holds."""
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"    {stage}: loss card {loss_card:.7f}, CPU {loss_cpu:.7f}, relative {rel:.3e} "
          f"(tolerance {TRAIN_LOSS_RTOL:.0e})", flush=True)
    require(rel <= TRAIN_LOSS_RTOL, f"{stage}: the loss differs card vs CPU")
    worst_grad = worst_param = 0.0
    settled = total = floored = 0
    card_params = dict(card.named_parameters())
    for name, p in cpu.named_parameters():
        q = card_params[name]
        if p.grad is None:
            require(q.grad is None, f"{stage}: {name} has a gradient on the card only")
            continue
        g, gap = p.grad, (p.grad - q.grad.cpu()).abs()
        scale = float(g.abs().max())
        require(float(gap.max()) <= max(TRAIN_GRAD_RTOL * scale, GRAD_FLOOR),
                f"{stage}: {name} gradient differs card vs CPU by {float(gap.max()):.3e} "
                f"of {scale:.3e}")
        if TRAIN_GRAD_RTOL * scale >= GRAD_FLOOR:
            worst_grad = max(worst_grad, float(gap.max()) / scale)
        else:
            floored += 1
        d = (p.detach() - q.detach().cpu()).abs()
        firm = (g.abs() > 1e-6) & (g.abs() > 10 * gap)
        require(bool((d[firm] <= 2e-6).all()) and bool((d <= 2 * lr + 2e-6).all()),
                f"{stage}: updated {name} differs card vs CPU by {float(d.max()):.3e}")
        worst_param = max(worst_param, float(d[firm].max()) if bool(firm.any()) else 0.0)
        settled, total = settled + int(firm.sum()), total + firm.numel()
    print(f"    {stage}: worst gradient gap {worst_grad:.3e} of its tensor's max |g| "
          f"(tolerance {TRAIN_GRAD_RTOL:.0e}; {floored} tensors with max |g| under "
          f"{GRAD_FLOOR / TRAIN_GRAD_RTOL:.0e} held to {GRAD_FLOOR:.0e} instead); worst updated-parameter gap {worst_param:.3e} "
          f"(tolerance 2e-6) over the {settled} of {total} elements whose gradient sign is "
          f"settled", flush=True)


def device_busy(trainer, steps: int):
    """(device-busy ms, wall ms, device events) over `steps` more train
    steps of a CLI's trainer (`profile_busy`)."""
    import itertools

    from seeme_tpu_torch.train.loop import run_epoch

    batches = itertools.islice(trainer.train_batches(trainer.preset.train.end_epoch), steps)

    def run():
        trainer.step = run_epoch(trainer.system, trainer.stage, trainer.optimizer,
                                 trainer.schedule, trainer.step, batches, trainer.generator)[0]

    return profile_busy(run)


def slice13_phases(dev, counted, counters, record, work: str) -> None:
    """Phases 48-54: the thirteenth slice. 48: DEBUG on the `--cfg` route
    (`config_mld_egobody.yaml DEBUG=true`: 32 / 16 / 16 samples and the
    cache fill's launches they imply, one epoch; `--nodebug`: 256 / 64 /
    64); 49: `demo --render --mesh` on the EgoBody config (kernels 1 / 3 / 1;
    the gifs' frames, or the refusal naming matplotlib where it is not
    installed); 50: the demo's card-sampled joints and meshes through the
    exporters, read back; 51: `tsne`'s latents card vs CPU; 52: the bound
    counts of kernels 1, 2, 3 and 5 against FlopCounterMode's count of
    their plain versions, and `flops`' six paths; 53: `preflight
    --end-to-end` on an asset tree the phase writes (kernel 5 once); 54:
    the pretrained text encoder card vs CPU, or its refusal naming
    transformers."""
    import importlib.util

    import numpy as np
    import torch

    from seeme_tpu_torch import demo
    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.data.humanml import SyntheticT2MDataset
    from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset
    from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
    from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
    from seeme_tpu_torch.models.text_encoder import ClipTextEncoder
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.ops import pointnet_fused as pfu
    from seeme_tpu_torch.tools import (export_bvh, export_fbx, export_gltf, export_obj, flops,
                                       preflight, tsne)
    from seeme_tpu_torch.train.__main__ import Trainer, parse_args

    none = {k: 0 for k in counters}
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    ego_yaml = os.path.join(configs, "config_mld_egobody.yaml")

    def sizes(dm):
        return tuple(sum(len(ix) for ix in dm.batch_indices(s, 1, shuffle=False, drop_last=False))
                     for s in ("train", "val", "test"))

    # ---- 48. DEBUG on the --cfg route, and --nodebug
    t = time.perf_counter()
    base = ["--cfg", ego_yaml, "--epochs", "1"]
    debug = Trainer(parse_args([*base, "--out", os.path.join(work, "debug"), "DEBUG=true"]))
    require(debug.preset.debug and sizes(debug.datamodule) == (32, 16, 16),
            f"DEBUG=true splits {sizes(debug.datamodule)}")
    # the batch (64) is clamped to the 32-sample train split; one chunk of
    # max(batch, 8) rows for train and one for val
    chunks = -(-32 // debug.batch_size) + -(-16 // debug.batch_size)
    _, counts = counted(debug.fill_feature_cache)
    require(counts == {**none, "pointnet_input_block": chunks, "pointnet_split_block": 3 * chunks},
            f"DEBUG cache fill launch counts {counts} (expected {chunks} / {3 * chunks})")
    record("train_cfg_debug_cache_fill", counts)
    _, fit_counts = counted(debug.fit)
    require(fit_counts == none and len(debug.history) == 1
            and math.isfinite(debug.history[-1]["means"]["total"]),
            f"DEBUG epoch: launches {fit_counts}, history {debug.history}")
    full = Trainer(parse_args([*base, "--nodebug", "--out", os.path.join(work, "nodebug"),
                               "DEBUG=true"]))
    require(not full.preset.debug and sizes(full.datamodule) == (256, 64, 64),
            f"--nodebug splits {sizes(full.datamodule)}")
    full_chunks = 256 // full.batch_size + -(-64 // full.batch_size)
    _, full_counts = counted(full.fill_feature_cache)
    require(full_counts == {**none, "pointnet_input_block": full_chunks,
                            "pointnet_split_block": 3 * full_chunks},
            f"--nodebug cache fill launch counts {full_counts}")
    record("train_cfg_nodebug_cache_fill", full_counts)
    del debug, full
    torch.cuda.empty_cache()
    phase(f"--cfg config_mld_egobody.yaml DEBUG=true: splits 32 / 16 / 16, batch clamped to 32, "
          f"cache fill launches {chunks} / {3 * chunks}, one epoch (loss finite); --nodebug: "
          f"256 / 64 / 64, cache fill {full_chunks} / {3 * full_chunks}", t)

    # ---- 49. demo --render (and --mesh, for the exporters) on the EgoBody config
    t = time.perf_counter()
    demo_dir = os.path.join(work, "demo_render")
    has_mpl = importlib.util.find_spec("matplotlib") is not None

    def run_demo():
        try:
            return demo.main(["--cfg", ego_yaml, "--render", "--mesh", "--num_samples", "1",
                              "--out", demo_dir]), None
        except ImportError as e:
            return None, e

    (saved, err), counts = counted(run_demo)
    require(counts == {**none, "pointnet_input_block": 1, "pointnet_split_block": 3,
                       "ddim_md_t1": 1}, f"demo --render launch counts {counts}")
    record("demo_render", counts)
    joints = np.load(os.path.join(demo_dir, "sample_0.npy"))
    if has_mpl:
        require(err is None, f"demo --render failed with matplotlib installed: {err}")
        from PIL import Image

        with Image.open(os.path.join(demo_dir, "sample_0.gif")) as im:
            require(im.n_frames == joints.shape[0],
                    f"sample_0.gif has {im.n_frames} frames, not {joints.shape[0]}")
        branch = f"matplotlib present: sample_0.gif of {joints.shape[0]} frames"
    else:
        require(err is not None and "matplotlib" in str(err),
                f"demo --render without matplotlib: {err!r}")
        branch = f"matplotlib absent: refused with ImportError({str(err)[:60]!r}...)"
    phase(f"demo --render --mesh (config_mld_egobody.yaml, 1 sample): launches {counts}; "
          f"{branch}", t)

    # ---- 50. the exporters on the demo's card-sampled joints and meshes
    t = time.perf_counter()
    mesh = np.load(os.path.join(demo_dir, "sample_0_mesh.npy"))
    faces_path = os.path.join(demo_dir, "faces.npy")
    faces = np.load(faces_path)
    out = os.path.join(work, "export")

    def obj_vertices(path):
        with open(path) as f:
            rows = [line.split()[1:] for line in f if line.startswith("v ")]
        return np.asarray(rows, np.float64)

    n = export_obj.main(["--npy", os.path.join(demo_dir, "sample_0_mesh.npy"), "--faces",
                         faces_path, "--stride", "20", "--out", os.path.join(out, "obj")])
    errs = {"obj": max(float(np.abs(obj_vertices(os.path.join(
        out, "obj", "seq_000", f"frame_{f:04d}.obj")) - mesh[f]).max()) for f in (0, 20, 40))}
    export_bvh.main(["--joints", os.path.join(demo_dir, "sample_0.npy"), "--out",
                     os.path.join(out, "m.bvh")])
    with open(os.path.join(out, "m.bvh")) as f:
        lines = f.read().splitlines()
    motion = np.asarray([line.split() for line in lines[lines.index("MOTION") + 3:]], np.float64)
    order = [export_bvh.SMPL_JOINT_NAMES.index(line.split()[1]) for line in lines
             if line.strip().startswith(("ROOT", "JOINT"))]
    parents = export_bvh.PARENTS
    local = np.stack([joints[:, j] - (joints[:, parents[j]] if parents[j] >= 0 else 0)
                      for j in order], 1).reshape(len(joints), -1)
    errs["bvh"] = float(np.abs(motion - local).max())
    export_gltf.main(["--npy", os.path.join(demo_dir, "sample_0.npy"), "--out",
                      os.path.join(out, "m.glb")])
    errs["gltf"] = float(np.abs(glb_tracks(os.path.join(out, "m.glb"), export_gltf)
                                - joints[:, :24]).max())
    fbx_out = export_fbx.main(["--mesh", os.path.join(demo_dir, "sample_0_mesh.npy"), "--faces",
                               faces_path, "--out", os.path.join(out, "a.fbx")])
    if export_fbx.bpy_available():
        require(os.path.exists(fbx_out), f"export_fbx wrote no {fbx_out}")
    else:
        errs["fbx obj"] = float(np.abs(obj_vertices(os.path.join(
            fbx_out, "frame_0007.obj")) - mesh[7]).max())
        export_fbx.main(["--joints", os.path.join(demo_dir, "sample_0.npy"), "--out",
                         os.path.join(out, "b.fbx")])
        errs["fbx glb"] = float(np.abs(glb_tracks(os.path.join(out, "b.glb"), export_gltf)
                                       - joints[:, :24]).max())
        poses = (np.random.RandomState(SEED).randn(8, 72) * 0.3).astype(np.float32)
        np.save(os.path.join(out, "poses.npy"), poses)
        export_fbx.main(["--poses", os.path.join(out, "poses.npy"), "--out",
                         os.path.join(out, "c.fbx")])
        card = glb_tracks(os.path.join(out, "c.glb"), export_gltf)
        cpu = export_fbx.pose_joints(poses, None, torch.device("cpu"))
        errs["fbx poses card vs CPU"] = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    require(all(v <= 1e-6 for k, v in errs.items() if "poses" not in k),
            f"exported files differ from the arrays: {errs}")
    require(errs.get("fbx poses card vs CPU", 0.0) <= 1e-5,
            f"export_fbx --poses joints card vs CPU: {errs}")
    fbx = "" if export_fbx.bpy_available() else ", export_fbx fallbacks (OBJ, glb, --poses glb)"
    shown = json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()})
    phase(f"exporters on the demo's sample_0 ({mesh.shape[0]} frames, {mesh.shape[1]} vertices, "
          f"{len(faces)} faces): {n} OBJ frames, BVH, glTF{fbx}; read back, max |file - array| "
          f"{shown}", t)

    # ---- 51. tsne: the latents on the card and on the CPU
    t = time.perf_counter()
    vae_yaml = os.path.join(configs, "config_vae_egobody.yaml")
    z, xy, method = tsne.compute(vae_yaml, num=64, device=dev)  # the whole test split
    z_cpu = tsne.compute(vae_yaml, num=64, device="cpu")[0]
    rel = float(np.abs(z - z_cpu).max() / np.abs(z_cpu).max())
    require(z.shape == (64, 256) and xy.shape == (64, 2) and rel <= 1e-5,
            f"tsne latents {z.shape} card vs CPU {rel}")
    phase(f"tsne (config_vae_egobody.yaml, the 64 test latents): card vs CPU {rel:.2e} of max, "
          f"projection {method}", t)

    # ---- 52. the bound counts against FlopCounterMode's count of the plain versions
    t = time.perf_counter()
    checks = {}
    meta = torch.device("meta")
    for H in (512, 256):
        pts = torch.empty(BATCH, HMR_POINTS, 3, device=meta)
        w = {"wpos": (3, 2 * H), "bpos": (2 * H,), "w0": (2 * H, H), "b0": (H,), "w1": (H, H),
             "b1": (H,), "ws": (2 * H, H)}
        args = [torch.empty(w[k], device=meta) for k in ("wpos", "bpos", "w0", "b0", "w1", "b1",
                                                          "ws")]
        x, pooled = pfu.fused_input_block_plain(pts, *args)
        checks[f"kernel 1 H={H}"] = (flops.count(lambda: pfu.fused_input_block_plain(pts, *args)),
                                     input_block_flops(BATCH, HMR_POINTS, H))
        sp = [torch.empty(s, device=meta) for s in ((H, H), (H, H), (H,), (H, H), (H,), (H, H),
                                                     (H, H))]
        checks[f"kernel 2 H={H}"] = (flops.count(lambda: pfu.fused_split_block_plain(x, pooled,
                                                                                     *sp)),
                                     split_block_flops(BATCH, HMR_POINTS, H))
    ego = SeeMeConfig()
    data = SyntheticEgoDataset(2, ego.motion_length, scene_points=16, seed=SEED)
    system = SeeMeSystem(ego, synthetic_smpl(6890), data.mean, data.std, device=dev, seed=SEED)
    sd = system.kernel_operands()[0]
    gen = torch.Generator().manual_seed(SEED)
    cond = torch.randn(BATCH, 2, 256, generator=gen).to(dev)
    z0 = torch.randn(BATCH, 1, 256, generator=gen).to(dev)
    steps = ego.num_inference_timesteps
    checks["kernel 3 (B=64, 2 cond, 50 steps)"] = (
        flops.count(lambda: dfu.ddim_fused_plain(sd, cond, z0, system.schedule, steps,
                                                 ego.num_layers, 1.0)),
        ddim_flops(sd, ego.num_layers, BATCH, 2, steps))
    del system
    t2c = T2MConfig()
    t2m = T2MSystem(t2c, np.zeros(263, np.float32), np.ones(263, np.float32), device=dev,
                    seed=SEED)
    tsd = t2m.kernel_operands()[0]
    text = torch.randn(2 * BATCH, 1, t2c.text_encoded_dim, generator=gen).to(dev)
    checks["kernel 5 (B=64, guidance 7.5, 50 steps)"] = (
        flops.count(lambda: dfu.ddim_fused_plain(tsd, text, z0, t2m.schedule, steps,
                                                 t2c.num_layers, t2c.guidance_scale,
                                                 md_trans=False)),
        tok_flops(tsd, t2c.num_layers, 2 * BATCH, 1, steps))
    del t2m
    torch.cuda.empty_cache()
    ratios = {k: counted_ / bound for k, (counted_, bound) in checks.items()}
    require(all(abs(r - 1) <= 0.01 for r in ratios.values()),
            f"bound counts vs FlopCounterMode's: {ratios}")
    paths = flops.main(["--batch_size", str(BATCH)])
    require(all(v > 0 for v in paths.values()), f"flops paths {paths}")
    phase("bound counts / FlopCounterMode's count of the plain version (gate 1 %): "
          + ", ".join(f"{k} {checks[k][1] / 1e9:.3f} GFLOP, ratio {ratios[k]:.4f}"
                      for k in checks)
          + "; flops paths (GFLOP): "
          + json.dumps({k: round(v / 1e9, 3) for k, v in paths.items()}), t)

    # ---- 53. preflight --end-to-end on a tree this phase writes
    t = time.perf_counter()
    deps = os.path.join(work, "deps")
    smpl_dir = os.path.join(deps, "smpl_models", "smpl")
    os.makedirs(smpl_dir)
    shutil.copy(os.path.join(work, "SMPL_NEUTRAL.pkl"), smpl_dir)
    t2m_cfg = T2MConfig()
    t2m_data = SyntheticT2MDataset(4, t2m_cfg.max_len, nfeats=t2m_cfg.nfeats, seed=SEED,
                                   text_dim=t2m_cfg.text_encoded_dim)
    t2m = T2MSystem(t2m_cfg, t2m_data.mean, t2m_data.std, device=dev, seed=SEED)
    os.makedirs(os.path.join(deps, "checkpoints_mld"))
    torch.save({"state_dict": t2m.state_dict(), "epoch": 0},
               os.path.join(deps, "checkpoints_mld", "epoch=0.ckpt"))
    del t2m
    trio = os.path.join(deps, "t2m", "t2m", "text_mot_match", "model")
    os.makedirs(trio)
    shutil.copy(os.path.join(work, "humanml3d_tm2t.tar"), os.path.join(trio, "finest.tar"))
    act = os.path.join(deps, "actionrecognition")
    os.makedirs(act)
    shutil.copy(os.path.join(work, "humanact12_gru.tar"), os.path.join(act, "humanact12_gru.tar"))
    shutil.copy(os.path.join(work, "uestc_stgcn.tar"), os.path.join(act, "uestc_rot6d_stgcn.tar"))
    (rc, rows), counts = counted(lambda: preflight.run(
        ["--deps", deps, "--datasets", os.path.join(work, "datasets"), "--end-to-end"]))
    require(counts == {**none, "ddim_tok_t1": 1}, f"preflight --end-to-end launch counts {counts}")
    record("preflight_end_to_end", counts)
    by = {r.asset: r for r in rows}
    written = ["SMPL_NEUTRAL.pkl", "MLD checkpoint (vae+denoiser)",
               "t2m text encoder (text_mot_match finest.tar)", "t2m motion encoder",
               "t2m movement encoder", "humanact12_gru.tar", "uestc_rot6d_stgcn.tar"]
    require(rc == 0 and all(by[a].status == "LOADED" for a in written)
            and by["end-to-end t2m metrics"].status == "RAN",
            f"preflight rc {rc}: " + "; ".join(f"{a} {by[a].status} {by[a].detail}"
                                              for a in [*written, "end-to-end t2m metrics"]))
    phase(f"preflight --end-to-end on a written tree: rc {rc}, {len(written)} assets LOADED, "
          f"end-to-end RAN ({by['end-to-end t2m metrics'].detail.split(';')[0]}), launches "
          f"{counts}, {sum(r.status == 'MISSING' for r in rows)} rows MISSING (not written)", t)

    # ---- 54. the pretrained text encoder
    t = time.perf_counter()
    if importlib.util.find_spec("transformers") is None:
        empty = os.path.join(work, "clip-tiny")
        os.makedirs(empty)
        with open(os.path.join(empty, "config.json"), "w") as f:
            f.write("{}")
        try:
            ClipTextEncoder(empty, device=dev)
            refused = None
        except ImportError as e:
            refused = e
        require(refused is not None and "transformers" in str(refused),
                f"a text-encoder directory without transformers: {refused!r}")
        phase(f"text encoder directory without transformers: refused with ImportError naming "
              f"it ({str(refused)[:70]!r}...)", t)
    else:
        import transformers

        path = os.path.join(work, "clip-tiny")
        write_tiny_clip(transformers, path)
        texts = ["a person walks", "jump", "a person turns and walks"]
        card = ClipTextEncoder(path, latent_dim=24, device=dev)(texts)
        cpu = ClipTextEncoder(path, latent_dim=24, device="cpu")(texts)
        rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        require(rel <= 1e-5, f"text encoder card vs CPU {rel}")
        phase(f"tiny CLIP text encoder (transformers {transformers.__version__}): card vs CPU "
              f"{rel:.2e} of max", t)


def glb_tracks(path: str, export_gltf):
    """(T, J, 3) joint tracks of a `.glb` `export_gltf` wrote."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    doc = export_gltf.parse_glb(data)
    start = 20 + int.from_bytes(data[12:16], "little") + 8
    tracks = []
    for sampler in doc["animations"][0]["samplers"]:
        view = doc["bufferViews"][doc["accessors"][sampler["output"]]["bufferView"]]
        raw = data[start + view["byteOffset"]:start + view["byteOffset"] + view["byteLength"]]
        tracks.append(np.frombuffer(raw, np.float32).reshape(-1, 3))
    return np.stack(tracks, 1)


def write_tiny_clip(transformers, path: str) -> None:
    """A 2-layer, 32-wide CLIP text tower projecting to 24, with a
    character-level BPE vocabulary, saved in PyTorch weights."""
    import json as _json

    import torch

    os.makedirs(path)
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab = {t: i for i, t in enumerate(letters + [f"{c}</w>" for c in letters])}
    vocab.update({"<|startoftext|>": len(vocab), "<|endoftext|>": len(vocab) + 1})
    with open(os.path.join(path, "vocab.json"), "w") as f:
        _json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    transformers.CLIPTokenizer(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"),
                               pad_token="<|endoftext|>").save_pretrained(path)
    cfg = transformers.CLIPTextConfig(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      max_position_embeddings=77, projection_dim=24,
                                      bos_token_id=vocab["<|startoftext|>"],
                                      eos_token_id=vocab["<|endoftext|>"],
                                      pad_token_id=vocab["<|endoftext|>"])
    torch.manual_seed(SEED)
    transformers.CLIPTextModelWithProjection(cfg).save_pretrained(path)


def profile_busy(run):
    """(device-busy ms, wall ms, device events) of `run()` under
    `torch.profiler`: the union of the device's kernel and copy intervals in
    the trace, against the host clock around the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the intervals, in microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, wall, len(spans)


def profile_fill(trainer) -> dict:
    """Device milliseconds of each PointNet kernel over one more cache fill,
    from `torch.profiler`; 'not measured' when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fill_feature_cache()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "block_kernel" in ev.key:  # input_block_kernel<512>, split_block_kernel<512>
            total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            out[ev.key] = {"ms_total": total / 1e3, "count": ev.count}
    return out or {"pointnet kernels": "not measured (no device time in the trace)"}


def print_launch(info: dict) -> None:
    """Print a DDIM kernel's cluster launch; fail unless it is a cluster of
    at least 2 CTAs of which at least one fits on the card."""
    clusters = info["grid"] // info["cluster"]
    print(f"    launch: clusters of {info['cluster']} CTAs, grid {info['grid']} CTAs "
          f"({clusters} clusters), {info['active_clusters']} clusters fit at once, "
          f"{info['smem_bytes']} B shared memory a CTA", flush=True)
    require(info["cluster"] >= 2 and info["active_clusters"] >= 1,
            f"cluster launch {info}")


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16
    tensor-core peak or bytes at the HBM rate, whichever is longer."""
    return 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def bound_by(flops: float, nbytes: float) -> str:
    return "operations" if flops / PEAK_FLOPS >= nbytes / PEAK_BYTES else "bytes"


def bound_f32_ms(flops: float, nbytes: float) -> float:
    """The same with operations at the f32 peak outside the tensor cores, the
    bound the earlier f32-FMA kernels were measured against."""
    return 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def floor_ms(flops: float, nbytes: float) -> float:
    """The least time of the split-bf16 scheme: three bf16 products for each
    f32 one."""
    return 1e3 * max(SPLIT_PRODUCTS * flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pointnet_rates(flops: float, nbytes: float, ms: float) -> str:
    return (f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bound_ms(flops, nbytes):.3f} ms "
            f"({bound_ms(flops, nbytes) / ms:.1%} of it), split-bf16 floor "
            f"{floor_ms(flops, nbytes):.3f} ms ({floor_ms(flops, nbytes) / ms:.1%}), f32 bound "
            f"{bound_f32_ms(flops, nbytes):.3f} ms")


def print_pointnet_launch(info: dict, tile: int) -> None:
    """Print a PointNet kernel's launch plan; fail unless it is a cluster of
    at least 2 CTAs of which at least one fits on the card, and its tile is
    `tile`, the points a CTA the wrapper sizes the pool by."""
    print(f"    launch: {info['tile']} points a CTA, clusters of {info['cluster']} CTAs sharing "
          f"each weight slot by TMA multicast, {info['stages']} ring slots of "
          f"{info['slot_bytes']} B, {info['smem_bytes']} B shared memory a CTA, "
          f"{info['active_clusters']} clusters fit at once", flush=True)
    require(info["cluster"] >= 2 and info["active_clusters"] >= 1
            and info["tile"] == tile, f"pointnet launch {info}")


def input_block_flops(B: int, N: int, H: int) -> float:
    """Operations of kernel 1 (`fused_input_block`) over B clouds of N
    points at hidden width H: fc_pos 3 -> 2H, then the first ResNet-FC
    block's fc_0 2H -> H, fc_1 H -> H and shortcut 2H -> H, for every point."""
    return 2.0 * B * N * (3 * 2 * H + 2 * H * H + H * H + 2 * H * H)


def split_block_flops(B: int, N: int, H: int) -> float:
    """Operations of kernel 2 (`fused_split_block`): each point's fc_0 and
    shortcut halves over x (H -> H each) and fc_1 (H -> H), and once per
    cloud the same two halves over the pooled feature."""
    return 2.0 * (B * N * 3 * H * H + 2 * B * H * H)


def ddim_flops(sd, num_layers: int, rows: int, n_cond: int, steps: int, tokens: int = 1) -> float:
    """Operations of one `ddim_fused` call from the weight shapes: the
    per-window precompute (condition and time-token projections) plus every
    step's work on the `tokens` latent rows of each of the `rows` sequences
    (`seeme_tpu/ops/denoiser_fused.py:864-925`, `fused_ddim_flops(n_tok=...)`;
    each latent row attends to tokens + n_cond + 1 keys)."""
    from seeme_tpu_torch.ops.denoiser_fused import layer_names

    def wf(name):  # flops per row through a Linear weight (out, in)
        w = sd[name]
        return 2.0 * w.shape[0] * w.shape[1]

    D = sd["encoder.norm.weight"].shape[0]
    total = steps * (wf("time_embedding.linear_1.weight") + wf("time_embedding.linear_2.weight"))
    for name in layer_names(num_layers):
        sa, ca, ffn = f"{name}.sa_block", f"{name}.ca_block", f"{name}.ffn"
        proj = 2.0 * D * D  # one of q, k, v
        total += rows * n_cond * (2 * proj + wf(f"{ca}.key.weight") + wf(f"{ca}.value.weight"))
        total += steps * (2 * proj + wf(f"{ca}.proj_out.emb_layers.1.weight")
                          + wf(f"{ffn}.proj_out.emb_layers.1.weight"))
        step = 3 * proj + 4.0 * D * (tokens + n_cond + 1) + wf(f"{sa}.self_attn.out_proj.weight")
        step += wf(f"{sa}.linear1.weight") + wf(f"{sa}.linear2.weight")
        step += wf(f"{ca}.query.weight") + 4.0 * D * n_cond
        step += wf(f"{ca}.proj_out.out_layers.2.weight")
        step += wf(f"{ffn}.linear1.weight") + wf(f"{ffn}.linear2.weight")
        step += wf(f"{ffn}.proj_out.out_layers.2.weight")
        total += steps * rows * tokens * step
    for j in range((num_layers - 1) // 2):
        total += steps * rows * tokens * wf(f"encoder.linear_blocks.{j}.weight")
    return total


def tok_flops(sd, num_layers: int, rows: int, n_cond: int, steps: int, tokens: int = 1) -> float:
    """Operations of one `ddim_fused_tok` call from the weight shapes: the
    per-window precompute (condition projection, every step's time token)
    plus every step's work on all S = tokens + 1 + n_cond token rows of each
    of the `rows` sequences (uncond and cond count apart), the token-path
    counterpart of `seeme_tpu/ops/denoiser_fused.py:864-925`."""
    from seeme_tpu_torch.ops.denoiser_fused import layer_names

    def wf(name):  # flops per row through a Linear weight (out, in)
        w = sd[name]
        return 2.0 * w.shape[0] * w.shape[1]

    D = sd["encoder.norm.weight"].shape[0]
    S = tokens + 1 + n_cond
    total = steps * (wf("time_embedding.linear_1.weight") + wf("time_embedding.linear_2.weight"))
    if "emb_proj.1.weight" in sd:
        total += rows * n_cond * wf("emb_proj.1.weight")
    for name in layer_names(num_layers):
        row = wf(f"{name}.self_attn.in_proj_weight") + 4.0 * D * S  # q/k/v, logits, value mix
        row += wf(f"{name}.self_attn.out_proj.weight")
        row += wf(f"{name}.linear1.weight") + wf(f"{name}.linear2.weight")
        total += steps * rows * S * row
    for j in range((num_layers - 1) // 2):
        total += steps * rows * S * wf(f"encoder.linear_blocks.{j}.weight")
    return total


def dispatch_phases(dev, counted, counters, record, card: str, work: str) -> None:
    """Phase 58: the train CLI's two routes in one process. Stage 2
    of `config_mld_egobody.yaml` (full width, B=64, 20 000 points, dropout
    0, validation every epoch, 2 epochs of 4 steps) with the cache, without
    it, and at guidance 2.5, each on the card's defaults (the split on the
    card, 8 steps a fetch) against the host route at 1 (`HOST_ROUTE_CFG`),
    then one epoch each of `config_mld_humanml3d.yaml` and
    `config_mld_humanact12.yaml` the same way. Gates: the routes and their
    log lines, parameters and every step's loss within 1e-6 of max (bitwise
    reported), the device route's fetches (one a group and one a
    validation: 2 an epoch at 4 steps), launches alike on both routes (1 /
    3 a step and a validation without the cache). Then, past the checks,
    each trainer runs one more epoch on its route, timed (ms a step on the
    host clock, ending in a synchronise; the median step by CUDA events),
    and one under `torch.profiler` (the device's idle share); and the
    split's GB on the card."""
    import numpy as np
    import torch

    from seeme_tpu_torch.train import __main__ as cli
    from seeme_tpu_torch.train import loop

    here = os.path.dirname(os.path.abspath(__file__))
    none = {k: 0 for k in counters}

    def run(name, args, epochs):
        """One trainer, its cache filled and fitted with counts and the
        fetches recorded; then, past the checks, one more epoch on its route
        timed on the host clock and one under `torch.profiler`."""
        fetches = []
        patch = _Patches()
        real_fetch = loop.fetch_steps

        def fetch(keys, rows):
            fetches.append(len(rows))
            return real_fetch(keys, rows)

        patch(loop, "fetch_steps", fetch)
        try:
            trainer = cli.Trainer(cli.parse_args([*args, "--epochs", str(epochs), "--out",
                                                  os.path.join(work, name)]))
            _, fill = counted(trainer.fill_feature_cache)
            _, fit = counted(trainer.fit)
        finally:
            patch.undo()
        rec = {"fill": fill, "fit": fit, "fetches": fetches, "route": trainer.route,
               "steps": [s["total"] for r in trainer.history for s in r["steps"]],
               "state": {k: v.detach().clone() for k, v in trainer.system.state_dict().items()},
               "steps_per_epoch": trainer.steps_per_epoch,
               "log": open(os.path.join(trainer.exp_dir, "train_log.txt")).read()}
        data, k = trainer.dispatch()

        def epoch():
            seed = trainer.seed + epochs
            common = dict(generator=trainer.generator, steps_per_dispatch=k)
            if data is not None:
                index = trainer.datamodule.batch_indices("train", trainer.batch_size, seed=seed)
                return loop.run_epoch_device(trainer.system, trainer.stage, trainer.optimizer,
                                             trainer.schedule, trainer.step, data, index, **common)
            return loop.run_epoch(trainer.system, trainer.stage, trainer.optimizer,
                                  trainer.schedule, trainer.step, trainer.train_batches(epochs),
                                  **common)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = epoch()
        torch.cuda.synchronize()
        rec["wall_ms"] = 1e3 * (time.perf_counter() - t0) / len(result[2])
        rec["event_ms"] = sorted(result[3])[len(result[3]) // 2]
        busy, wall, _ = profile_busy(epoch)
        rec["idle"] = 1 - busy / wall
        del trainer, data
        torch.cuda.empty_cache()
        return rec

    def pair(label, args, epochs):
        """Device route, then host route, on the same args; their agreement."""
        d, h = (run(f"{label}_{route}", [*args, *extra], epochs)
                for route, extra in (("device", []), ("host", HOST_ROUTE_CFG)))
        require(d["route"] == ("device", 8) and h["route"] == ("host", 1),
                f"{label}: routes {d['route']} / {h['route']}")
        require("steps/dispatch" in d["log"] and ", 8 steps/dispatch" in d["log"]
                and "device-resident train split: " in d["log"], f"{label}: device log")
        require("host batches (TRAIN.DEVICE_DATA off), 1 steps/dispatch" in h["log"],
                f"{label}: host log")
        worst = max(float((v - h["state"][k]).abs().max()) / max(float(h["state"][k].abs().max()),
                                                                  1e-30)
                    for k, v in d["state"].items())
        bitwise = all(torch.equal(v, h["state"][k]) for k, v in d["state"].items())
        loss_rel = float(np.max(np.abs(np.subtract(d["steps"], h["steps"]))
                                / np.abs(h["steps"])))
        require(len(d["steps"]) == len(h["steps"]) == epochs * d["steps_per_epoch"],
                f"{label}: steps {len(d['steps'])} / {len(h['steps'])}")
        require(worst <= DISPATCH_RTOL and loss_rel <= DISPATCH_RTOL,
                f"{label}: device vs host parameters {worst:.3e}, losses {loss_rel:.3e}")
        require(d["fit"] == h["fit"] and d["fill"] == h["fill"],
                f"{label}: launches device {d['fill']} {d['fit']}, host {h['fill']} {h['fit']}")
        gb = re.search(r"device-resident train split: ([0-9.]+) GB", d["log"]).group(1)
        return d, h, worst, bitwise, loss_rel, gb

    mld = [os.path.join(here, "configs", "config_mld_egobody.yaml"), "model.droupout=0.0",
           "LOGGER.VAL_EVERY_STEPS=1"]
    t = time.perf_counter()
    results = {}
    for label, extra in (("cached", []), ("raw", ["TRAIN.FEATURE_CACHE=false"]),
                         ("guidance_2.5", ["model.guidance_scale=2.5"])):
        d, h, worst, bitwise, loss_rel, gb = pair(label, ["--cfg", *mld, *extra], 2)
        if label == "cached":
            require(d["fetches"] == [4, 1, 4, 1] and h["fetches"] == [1] * 10,
                    f"cached: fetches device {d['fetches']}, host {h['fetches']}")
            require(d["fit"] == none and d["fill"] == {**none, "pointnet_input_block": 5,
                                                        "pointnet_split_block": 15},
                    f"cached: launches {d['fill']} {d['fit']}")
        else:  # 8 steps and 2 validations, each encoding the raw scene once
            require(d["fit"] == {**none, "pointnet_input_block": 10, "pointnet_split_block": 30},
                    f"{label}: launches {d['fit']}")
        record(f"dispatch_{label}_device_route", d["fit"])
        results[label] = (d, h)
        print(f"    {label}: device route {d['wall_ms']:.3f} ms a step on the host clock "
              f"({d['event_ms']:.3f} by CUDA events), idle {d['idle']:.3f}, split {gb} GB, "
              f"fetches {d['fetches']}; host route {h['wall_ms']:.3f} ms ({h['event_ms']:.3f}), "
              f"idle {h['idle']:.3f}, fetches {h['fetches']}; parameters "
              f"{'bitwise' if bitwise else f'{worst:.2e} of max'}, losses {loss_rel:.2e}; "
              f"launches {d['fit']}", flush=True)
    phase(f"dispatch routes, stage 2 of config_mld_egobody.yaml at B={BATCH} (2 epochs of 4 "
          f"steps, dropout 0): device (the card's defaults) against host (1 step a fetch) "
          f"with the cache, without it and at guidance 2.5, within {DISPATCH_RTOL:.0e} | "
          f"{card}", t)
    t = time.perf_counter()
    for name in ("mld_humanml3d", "mld_humanact12"):
        d, h, worst, bitwise, loss_rel, gb = pair(
            name, ["--cfg", os.path.join(here, "configs", f"config_{name}.yaml")], 1)
        require(d["fit"] == none and len(d["fetches"]) >= 1, f"{name}: {d['fit']} {d['fetches']}")
        print(f"    {name}: {d['steps_per_epoch']} steps, device route {d['wall_ms']:.3f} ms a "
              f"step, idle {d['idle']:.3f}, split {gb} GB, fetches {d['fetches']}; host "
              f"{h['wall_ms']:.3f} ms, idle {h['idle']:.3f}, fetches "
              f"{h['fetches']}; parameters {'bitwise' if bitwise else f'{worst:.2e} of max'}, "
              f"losses {loss_rel:.2e}", flush=True)
    phase(f"dispatch routes, one epoch of config_mld_humanml3d.yaml and "
          f"config_mld_humanact12.yaml: device against host within {DISPATCH_RTOL:.0e} | {card}",
          t)


def run_group(cmd: list, timeout: float) -> subprocess.CompletedProcess:
    """`cmd` in a session of its own, its output captured; the whole process
    group is killed at the time limit (torchrun's ranks with it)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        out += f"\n(killed at the {timeout} s limit)"
    return subprocess.CompletedProcess(cmd, proc.returncode, out)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_phases(dev, record, card: str, work: str) -> None:
    """Phases 55-57: data parallelism (`seeme_tpu_torch/parallel/`). 55: stage
    2 (`config_mld_egobody.yaml`, full width, B=64, 20 000 points, the
    synthetic split, dropout 0 so that the ranks' rows draw what one process
    draws) through `torch.distributed.run --nproc_per_node 2` of the train
    CLI on the one card (gloo; NCCL with two cards or more), against the
    same run in one process: the first step's gradients, the loss trajectory, the
    validations, the parameters across the ranks after every epoch, each
    rank's cache fill launches, one checkpoint directory; 56: the same at
    `--nproc_per_node` = the card count over NCCL; 57: the ego test CLI on
    55's one-process checkpoint at 2 ranks against one process (metrics,
    launches per rank, kernel 3's rows). Each runs `python3 chip_smoke.py
    --ddp-worker` (`ddp_worker`), which holds the hooks."""
    import numpy as np
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "chip_smoke.py")
    mld_yaml = os.path.join(here, "configs", "config_mld_egobody.yaml")
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.ops import pointnet_fused as pfu

    none = {k: 0 for k in counter_table(pfu, dfu)}

    def launch(name, kind, nproc, cli_args):
        """`nproc` ranks under torchrun, or (0) the one-process reference in
        this process; (their out dir, each rank's record, seconds)."""
        out = os.path.join(work, name)
        cli_args = [*cli_args, "--out", os.path.join(out, "exp")]
        t = time.perf_counter()
        if nproc:
            proc = run_group([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                              str(nproc), "--master_addr", "localhost", "--master_port",
                              str(free_port()), script, "--ddp-worker", kind, out, *cli_args],
                             600)
            if proc.returncode != 0:
                print(proc.stdout[-6000:], flush=True)
            require(proc.returncode == 0, f"{name}: rc {proc.returncode}")
        else:
            ddp_worker(kind, out, cli_args)
            torch.cuda.empty_cache()
        seconds = time.perf_counter() - t
        ranks = []
        for r in range(max(nproc, 1)):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        return out, ranks, seconds

    def rates(ranks) -> str:
        """Each rank's ms a step (a sampled batch), peak memory, idle share
        and seconds in the CLI."""
        def one(x):
            ms = (f"{np.mean(x['step_ms'][1:]):.3f} ms a step" if "step_ms" in x else
                  f"{np.mean([c['ms'] for c in x['calls']]):.3f} ms a sampled batch")
            return (f"{ms}, peak {x['peak_bytes'] / 2**30:.2f} GiB, idle "
                    f"{1 - x['busy_ms'] / x['wall_ms']:.3f}, {x['seconds']:.1f} s in the CLI")

        return "; ".join(f"rank {r}: {one(x)}" for r, x in enumerate(ranks))

    def checkpoint_dirs(root):
        return [d for d, sub, _ in os.walk(root) if os.path.basename(d) == "checkpoints"]

    base_args = ["--cfg", mld_yaml, "--epochs", "2", "model.droupout=0.0",
                 "LOGGER.VAL_EVERY_STEPS=1"]
    train_args = [*base_args, *HOST_ROUTE_CFG]
    t = time.perf_counter()
    one_dir, (one,), one_s = launch("train_one", "train", 0, train_args)
    one_grads = torch.load(os.path.join(one_dir, "grads0.pt"))
    one_ckpts = checkpoint_dirs(one_dir)
    require(len(one_ckpts) == 1, f"one process wrote checkpoint dirs {one_ckpts}")
    fill = {**none, "pointnet_input_block": 5, "pointnet_split_block": 15}
    require(one["fill"] == fill and one["fit"] == none,
            f"one process: cache fill {one['fill']}, epochs {one['fit']}")
    phase(f"data-parallel reference: the train CLI in one process (B=64, {len(one['steps'])} "
          f"steps, dropout 0): {rates([one])}, {one_s:.1f} s | {card}", t)

    def check_train(label, out, ranks, world, backend):
        require(all(x["world"] == world and x["backend"] == backend for x in ranks),
                f"{label}: world / backend {[(x['world'], x['backend']) for x in ranks]}")
        worst = 0.0
        for r, x in enumerate(ranks):
            require(x["fill"] == fill and x["fit"] == none,
                    f"{label} rank {r}: cache fill {x['fill']}, epochs {x['fit']}")
            record(f"ddp_{label}_cache_fill_rank{r}", x["fill"])
            require(x["hashes"] == ranks[0]["hashes"] and len(x["hashes"]) == 2,
                    f"{label}: parameters differ across the ranks after an epoch")
            grads = torch.load(os.path.join(out, f"grads{r}.pt"))
            require(grads.keys() == one_grads.keys(),
                    f"{label} rank {r}: gradients of {sorted(set(grads) ^ set(one_grads))[:4]}")
            for n, g in one_grads.items():
                scale = float(g.abs().max())
                err = float((grads[n] - g).abs().max())
                worst = max(worst, err / max(scale, 1e-30))
                require(err <= max(1e-5 * scale, GRAD_FLOOR),
                        f"{label} rank {r}: gradient {n} off by {err:.3e} of max {scale:.3e}")
        steps = np.asarray(ranks[0]["steps"])
        rel = float(np.max(np.abs(steps - one["steps"]) / np.abs(one["steps"])))
        vrel = float(np.max(np.abs(np.asarray(ranks[0]["val"]) - one["val"])
                            / np.abs(one["val"])))
        require(len(steps) == len(one["steps"]) and rel <= TRAIN_LOSS_RTOL and vrel <= 1e-4,
                f"{label}: losses {steps} against one process's {one['steps']}")
        dirs = checkpoint_dirs(out)
        require(len(dirs) == 1 and sorted(os.listdir(dirs[0])) == sorted(os.listdir(one_ckpts[0])),
                f"{label}: checkpoint dirs {dirs}")
        return worst, rel, vrel

    # ---- 55. two ranks, against one process: on one card they share it (gloo)
    t = time.perf_counter()
    cards = torch.cuda.device_count()
    out, ranks, seconds = launch("train_two", "train", 2, train_args)
    worst, rel, vrel = check_train("train_gloo", out, ranks, 2, "nccl" if cards >= 2 else "gloo")
    phase(f"DDP stage 2 (config_mld_egobody.yaml, B=64 as 2 x 32, world 2, backend "
          f"{ranks[0]['backend']}, {cards} card(s)): first-step gradients within {worst:.2e} "
          f"of each max |g| (gate 1e-05), losses within {rel:.2e} (gate {TRAIN_LOSS_RTOL:.0e}), "
          f"validations {vrel:.2e}, parameters bitwise alike on both ranks after each epoch, "
          f"each rank's cache fill 5 / 15, one checkpoint dir; {rates(ranks)}; {seconds:.1f} s "
          f"| {card}", t)

    # ---- 56. one rank a card over NCCL (world 1 on a one-card machine)
    t = time.perf_counter()
    out, ranks, seconds = launch("train_nccl", "train", cards, train_args)
    worst, rel, vrel = check_train("train_nccl", out, ranks, cards, "nccl")
    phase(f"DDP stage 2 at --nproc_per_node {cards} (world {ranks[0]['world']}, backend "
          f"{ranks[0]['backend']}): gradients within {worst:.2e}, losses within {rel:.2e}, "
          f"validations {vrel:.2e} of one process's; {rates(ranks)}; {seconds:.1f} s | {card}", t)

    # ---- 57. the ego test CLI at two ranks, against one process
    t = time.perf_counter()
    ckpt = os.path.join(one_ckpts[0], sorted(os.listdir(one_ckpts[0]))[-1])
    test_args = ["--cfg", mld_yaml, "--batch_size", str(BATCH), "--replication_times", "2",
                 "--checkpoint", ckpt]
    _, (tone,), _ = launch("test_one", "test", 0, test_args)
    _, ranks, seconds = launch("test_two", "test", 2, test_args)
    keys = ("MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR", "ACCL")
    worst = 0.0
    for r, x in enumerate(ranks):
        require(x["world"] == 2, f"test rank {r}: world {x['world']}")
        expected = {**none, "pointnet_input_block": 1, "pointnet_split_block": 3,
                    "ddim_md_t1": 2}
        require(x["counts"] == expected, f"test rank {r}: launches {x['counts']}")
        record(f"ddp_test_cli_rank{r}", x["counts"])
        require([(c["rows"], c["kernel3"]) for c in x["calls"]] == [(BATCH // 2, 1)] * 2,
                f"test rank {r}: sampling calls {x['calls']}")
        for got, want in zip(x["replications"], tone["replications"]):
            require(all(k in got for k in keys) and got.keys() == want.keys(),
                    f"test rank {r}: metrics {sorted(got)}")
            for k in keys:
                err = abs(got[k] - want[k]) / abs(want[k])
                worst = max(worst, err)
                require(err <= 1e-6, f"test rank {r}: {k} {got[k]} against one process's "
                                     f"{want[k]}")
    phase(f"test CLI (config_mld_egobody.yaml on phase 55's one-process checkpoint, 2 "
          f"replications of the 64-sample split) at world 2: MPJPE / ROOT / HEAD / ACCL within "
          f"{worst:.2e} of one process's (gate 1e-06); each rank input block 1, split block 3, "
          f"kernel 3 once a batch and replication at {BATCH // 2} rows; {rates(ranks)}; "
          f"{seconds:.1f} s | {card}", t)

    # ---- 59-60. one torchrun of two ranks: the device route, the model axis, shard_params
    t = time.perf_counter()
    out = os.path.join(work, "slice15")
    proc = run_group([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                      "--master_addr", "localhost", "--master_port", str(free_port()), script,
                      "--ddp-worker", "slice15", out, *base_args], 900)
    if proc.returncode != 0:
        print(proc.stdout[-6000:], flush=True)
    require(proc.returncode == 0, f"phases 59-60: rc {proc.returncode}")
    seconds = time.perf_counter() - t

    def ranks_of(name):
        return [json.load(open(os.path.join(out, name, f"rank{r}.json"))) for r in range(2)]

    backend = "nccl" if cards >= 2 else "gloo"
    ranks = ranks_of("59")
    worst, rel, vrel = check_train("device_route", os.path.join(out, "59"), ranks, 2, backend)
    for r, x in enumerate(ranks):
        require(x["route"] == ["device", 8] and x["fetches"] == [4, 1, 4, 1],
                f"phase 59 rank {r}: route {x['route']}, fetches {x['fetches']}")
    phase(f"DDP on the device route (the card's defaults: the split on the card, 8 steps a "
          f"fetch; world 2, backend {ranks[0]['backend']}) against phase 55's one process on "
          f"the host route: first-step gradients within {worst:.2e} of each max |g|, losses "
          f"within {rel:.2e}, validations {vrel:.2e}, parameters bitwise alike on both ranks "
          f"after each epoch, fill 5 / 15 a rank, 2 fetches an epoch (4 steps + validation); "
          f"{rates(ranks)} | {card}", t)
    t = time.perf_counter()
    ranks = ranks_of("60")
    worst, rel, vrel = check_train("model_axis", os.path.join(out, "60"), ranks, 2, backend)
    require(all(x["shard"] == [0, 1] for x in ranks),
            f"phase 60: data shards {[x['shard'] for x in ranks]}")
    shards = ranks_of("shard")
    for r, x in enumerate(shards):
        require(abs(x["loss"] - x["twin_loss"]) <= SHARD_LOSS_RTOL * abs(x["twin_loss"]),
                f"phase 60 rank {r}: sharded loss {x['loss']} against {x['twin_loss']}")
        require(x["param_rel"] <= SHARD_PARAM_RTOL,
                f"phase 60 rank {r}: parameters {x['param_rel']:.3e} of max off")
        require(x["sharded"] > 0 and 2 * x["stored"] == x["whole"]
                and x["trained"] > 0 and 2 * x["moments"] == x["trained"],
                f"phase 60 rank {r}: storage {x['stored']} of {x['whole']}, moments "
                f"{x['moments']} of {x['trained']}")
        require(x["gathered_rel"] <= DISPATCH_RTOL and x["after_rel"] <= DDIM_RTOL
                and x["moved"] > 0, f"phase 60 rank {r}: samples {x}")
        require(x["counts"] == {**none, "pointnet_input_block": 1, "pointnet_split_block": 3,
                                "ddim_md_t1": 1}, f"phase 60 rank {r}: launches {x['counts']}")
        record(f"model_axis_sharded_sample_rank{r}", x["counts"])
    x = shards[0]
    phase(f"MESH.MODEL_AXIS=2 at world 2 (a 1 x 2 mesh): the train CLI against phase 55's one "
          f"process, gradients within {worst:.2e}, losses {rel:.2e}, validations {vrel:.2e}; "
          f"shard_params on SeeMeConfig() at B={BATCH} (20 000 points): {x['sharded']} of "
          f"{x['params']} parameters sharded, each rank storing {x['stored']} of their "
          f"{x['whole']} elements and {x['moments']} of {x['trained']} AdamW moments; the "
          f"step's loss within {abs(x['loss'] - x['twin_loss']) / abs(x['twin_loss']):.2e} "
          f"of the replicated step's, parameters {x['param_rel']:.2e} of max; kernel 3 from "
          f"gathered operands {'bitwise' if x['gathered_bitwise'] else x['gathered_rel']} the "
          f"unsharded sample, after the step {x['after_rel']:.2e} of the replicated one's; "
          f"launches {x['counts']}; step {x['ms']:.3f} ms sharded, {x['twin_ms']:.3f} "
          f"replicated (gloo gathers, a record); {rates(ranks)}; phases 59-60 {seconds:.1f} s "
          f"| {card}", t)


class _Patches:
    """Attributes replaced for a while and put back by `undo`."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, new):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def undo(self):
        for obj, name, old in reversed(self.saved):
            setattr(obj, name, old)
        self.saved = []


def train_record(out: str, cli_args: list):
    """The train CLI's `main(cli_args)` with counting hooks (undone after):
    (its trainer, a record of the rank's launches in the cache fill and in
    the epochs, a SHA-256 of the whole state dict after every epoch, each
    step's loss and ms, each validation, the route, the device-to-host
    fetches of loss terms, the peak memory and the device's busy time over
    the epochs (`profile_busy`)); writes `out/grads<r>.pt`, the first
    step's (averaged) gradients."""
    import hashlib

    import torch

    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.ops import pointnet_fused as pfu
    from seeme_tpu_torch.train import __main__ as cli
    from seeme_tpu_torch.train import loop

    os.makedirs(out, exist_ok=True)
    counters = counter_table(pfu, dfu)
    rec, grads, hashes, fetches = {"kind": "train"}, {}, [], []
    real_step, real_fetch = loop.device_step, loop.fetch_steps
    real_fill, real_fit = cli.Trainer.fill_feature_cache, cli.Trainer.fit
    patch = _Patches()

    def step(system, *a, **k):
        result = real_step(system, *a, **k)
        if not grads:  # the first step's (averaged) gradients
            grads.update({n: p.grad.detach().cpu() for n, p in system.named_parameters()
                          if p.grad is not None})
        return result

    def fetch(keys, rows):
        fetches.append(len(rows))
        return real_fetch(keys, rows)

    def hashed(real):
        def epoch(system, *a, **k):
            result = real(system, *a, **k)
            h = hashlib.sha256()
            for name, v in sorted(system.state_dict().items()):
                h.update(name.encode())
                h.update(v.detach().cpu().numpy().tobytes())
            hashes.append(h.hexdigest())
            return result
        return epoch

    def fill(trainer):
        zero_counters(counters, pfu)
        seconds = real_fill(trainer)
        torch.cuda.synchronize()
        rec["fill"], rec["fill_s"] = read_counters(counters, pfu, dfu), seconds
        return seconds

    def fit(trainer):
        zero_counters(counters, pfu)
        torch.cuda.reset_peak_memory_stats()
        history = []
        rec["busy_ms"], rec["wall_ms"], _ = profile_busy(
            lambda: history.append(real_fit(trainer)))
        rec["fit"] = read_counters(counters, pfu, dfu)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        return history[0]

    patch(loop, "device_step", step)
    patch(loop, "fetch_steps", fetch)
    patch(cli, "run_epoch", hashed(cli.run_epoch))
    patch(cli, "run_epoch_device", hashed(cli.run_epoch_device))
    patch(cli.Trainer, "fill_feature_cache", fill)
    patch(cli.Trainer, "fit", fit)
    t0 = time.perf_counter()
    try:
        trainer = cli.main(cli_args)
    finally:
        patch.undo()
    rec.update(world=trainer.world, backend=trainer.backend, device=str(trainer.device),
               steps=[s["total"] for r in trainer.history for s in r["steps"]],
               step_ms=[m for r in trainer.history for m in r["step_ms"]],
               val=[r["val"]["total"] for r in trainer.history if "val" in r],
               hashes=hashes, checkpoints=trainer.checkpoints, route=list(trainer.route),
               shard=list(trainer.shard), fetches=fetches,
               seconds=time.perf_counter() - t0)
    torch.save(grads, os.path.join(out, f"grads{trainer.rank}.pt"))
    return trainer, rec


def test_record(cli_args: list) -> dict:
    """The test CLI's `main(cli_args)` with counting hooks (undone after):
    its replications' metrics, its launches, and each `sample_from_cond`
    call's rows, kernel-3 launches and ms."""
    import torch

    from seeme_tpu_torch.models.seeme import SeeMeSystem
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.ops import pointnet_fused as pfu
    from seeme_tpu_torch.test import __main__ as cli

    counters = counter_table(pfu, dfu)
    calls, real_sample = [], SeeMeSystem.sample_from_cond
    patch = _Patches()

    def sample(system, cond, generator=None, z_init=None, noise=None):
        before = dfu.ddim_fused.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        feats = real_sample(system, cond, generator=generator, z_init=z_init, noise=noise)
        end.record()
        torch.cuda.synchronize()
        calls.append({"rows": int(z_init.shape[0]), "ms": start.elapsed_time(end),
                      "kernel3": dfu.ddim_fused.launches - before})
        return feats

    patch(SeeMeSystem, "sample_from_cond", sample)
    zero_counters(counters, pfu)
    torch.cuda.reset_peak_memory_stats()
    result = []
    t0 = time.perf_counter()
    try:
        busy, wall, _ = profile_busy(lambda: result.append(cli.main(cli_args)))
    finally:
        patch.undo()
    return {"kind": "test", "busy_ms": busy, "wall_ms": wall,
            "world": int(os.environ.get("WORLD_SIZE", 1)),
            "replications": result[0]["replications"], "calls": calls,
            "counts": read_counters(counters, pfu, dfu),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0}


def ddp_worker(kind: str, out: str, cli_args: list) -> None:
    """One process of phases 55-57: `train_record` or `test_record` of the
    CLI's `cli_args`, then `out/rank<r>.json`; of phases 59-60,
    `slice15_worker`. Under torchrun it runs as `python3 chip_smoke.py
    --ddp-worker train|test|slice15 OUT CLI_ARGS...`; the one-process
    reference runs it in this process."""
    os.makedirs(out, exist_ok=True)
    if kind == "slice15":
        slice15_worker(out, cli_args)
        return
    if kind == "train":
        trainer, rec = train_record(out, cli_args)
        rank = trainer.rank
    else:
        rec = test_record(cli_args)
        rank = int(os.environ.get("RANK", 0))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def slice15_worker(out: str, base_args: list) -> None:
    """One rank of phases 59-60, which joins the process group itself (the
    CLIs then find it and leave it be): `train_record` of the train CLI on
    `base_args` with the card's default route (59: the device route, 8
    steps a fetch) into `out/59`, then at `MESH.MODEL_AXIS=2` (60, a (1, 2)
    mesh) into `out/60`, then `shard_record` into `out/shard`; each writes
    `rank<r>.json`."""
    import torch
    import torch.distributed as dist

    from seeme_tpu_torch.parallel import initialize_multihost

    dev, _ = initialize_multihost(device="cuda")
    try:
        for name, extra in (("59", []), ("60", ["MESH.MODEL_AXIS=2"])):
            sub = os.path.join(out, name)
            trainer, rec = train_record(sub, [*base_args, *extra, "--out",
                                              os.path.join(sub, "exp")])
            with open(os.path.join(sub, f"rank{trainer.rank}.json"), "w") as f:
                json.dump(rec, f)
            del trainer
            torch.cuda.empty_cache()
        rec = shard_record(dev)
        os.makedirs(os.path.join(out, "shard"), exist_ok=True)
        with open(os.path.join(out, "shard", f"rank{dist.get_rank()}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def slice16_phases(dev, counted, counters, record, work: str) -> None:
    """Phases 61-64: the sixteenth slice. 61: the EgoBody config of
    `config_mld_egobody.yaml` at full width (B=64, 20 000 points) as shipped
    (kernel 3 once) and with `model.scheduler.eta=0.5`, `model.use_fused=false`
    and `model.num_head=4`, each sampling through the `ddim_sample` loop
    (PointNet 1 / 3, no DDIM kernel), each route's `sample_from_cond` ms,
    and each loop route card vs CPU on a small input with its initial and
    per-step noise injected (latents 1e-3 of max|z|, features 1e-3 of max).
    62: ProHMR-Scene `forward_step` with every camera switch off and the glow
    without batch norm, at B=64 (kernels 1-2 at H=256 1 / 3), ms and peak
    memory, card vs CPU as phase 18. 63: an EgoHMR training step with every
    camera switch off and `only_mask_img_cond=False`: card vs CPU at the
    CLI's batch with phase 29's ReLU-decision replay (one sample's whole
    condition dropped), then timed at B=64 with 20 000 points (1 / 3 a step).
    64: `--cfg config_vae_egobody.yaml TRAIN.RESUME=<exp dir>` on the card:
    the run resumes at the saved step and epoch and deletes no step file; a
    mistyped RESUME raises before anything is deleted."""
    import torch

    from seeme_tpu_torch import train_egohmr
    from seeme_tpu_torch import train_prohmr_scene as train_prohmr
    from seeme_tpu_torch.config import build as config_build
    from seeme_tpu_torch.config import loader
    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.data import egohmr_images as images
    from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
    from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
    from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
    from seeme_tpu_torch.models.seeme import SeeMeSystem
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.train.__main__ import main as train_main

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    none = {k: 0 for k in counters}
    pointnet_512 = {**none, "pointnet_input_block": 1, "pointnet_split_block": 3}
    pointnet_256 = {**none, "pointnet_input_block_h256": 1, "pointnet_split_block_h256": 3}
    smpl = synthetic_smpl(n_verts=6890, seed=SEED)

    # ---- 61. the EgoBody sampling routes of config_mld_egobody.yaml
    data = SyntheticEgoDataset(BATCH, 60, scene_points=HMR_POINTS, seed=SEED)
    batch = to_torch(data.batch(0, BATCH), dev)
    small = {k: v[:2].cpu() for k, v in batch.items()}
    small["scene"] = small["scene"][:, :512].contiguous()
    routes = {}
    for label, overrides in (("shipped", []), ("eta 0.5", ["model.scheduler.eta=0.5"]),
                             ("use_fused false", ["model.use_fused=false"]),
                             ("num_head 4", ["model.num_head=4"])):
        t = time.perf_counter()
        cfg = config_build.preset_from_yaml(loader.load_config(
            os.path.join(configs, "config_mld_egobody.yaml"),
            overrides=loader.parse_dotted_overrides(overrides))).model
        require(cfg.scene_points == HMR_POINTS and cfg.latent_dim == (1, 256),
                f"{label}: config {cfg}")
        system = SeeMeSystem(cfg, smpl, data.mean, data.std, device=dev, seed=SEED)
        perturb_parameters_(system, torch.Generator().manual_seed(SEED + 80))
        gen = torch.Generator(device=dev).manual_seed(SEED + 81)
        loop = not system.takes_kernel(2)
        require(loop == bool(overrides), f"{label}: takes the kernel {not loop}")

        def ego_slice():
            feats = system.sample_from_cond(system.encode_conditioning(batch), generator=gen)
            return feats, system.eval_fk(batch, feats)

        (feats, out), counts = counted(ego_slice)
        require(counts == (pointnet_512 if loop else {**pointnet_512, "ddim_md_t1": 1}),
                f"{label}: launch counts {counts}")
        record(f"egobody_{label.replace(' ', '_')}", counts)
        for k, v in {"feats": feats, **out}.items():
            require(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")
        cond = system.encode_conditioning(batch)
        routes[label] = time_ms(lambda: system.sample_from_cond(cond, generator=gen), 2)
        checked = ""
        if loop:  # card vs CPU, the latents caught on their way to the decoder
            steps = cfg.num_inference_timesteps
            g = torch.Generator().manual_seed(SEED + 82)
            z0 = torch.randn(2, *cfg.latent_dim, generator=g)
            noise = torch.randn(steps, 2, *cfg.latent_dim, generator=g)
            cpu = SeeMeSystem(cfg, smpl, data.mean, data.std, device="cpu", seed=SEED)
            cpu.load_state_dict({k: v.cpu() for k, v in system.state_dict().items()})
            got, want = {}, {}
            for where, m, inputs in ((got, system, {k: v.to(dev) for k, v in small.items()}),
                                     (want, cpu, small)):
                decode = m.vae.decode
                m.vae.decode = lambda z, *a, _d=decode, _w=where, **k: (
                    _w.__setitem__("z", z), _d(z, *a, **k))[1]
                try:
                    where["feats"] = m.sample_from_cond(
                        m.encode_conditioning(inputs), z_init=z0.to(m.device),
                        noise=noise.to(m.device))
                finally:
                    del m.vae.decode
            compare(f"{label} loop latents, card vs CPU", got["z"].cpu(), want["z"],
                    float(want["z"].abs().max()), DDIM_RTOL)
            compare(f"{label} loop features, card vs CPU", got["feats"].cpu(), want["feats"],
                    float(want["feats"].abs().max()), SLICE_RTOL)
            checked = ", card vs CPU (B=2, 512 points, noise injected) agrees"
            del cpu
        del system, feats, out, cond
        torch.cuda.empty_cache()
        phase(f"EgoBody {label} (config_mld_egobody.yaml, B={BATCH}, {HMR_POINTS} points): "
              f"{'the ddim_sample loop' if loop else 'kernel 3'}, launches {counts}, "
              f"sample_from_cond {routes[label]:.3f} ms{checked}", t)
    phase(f"EgoBody sampling routes, sample_from_cond ms at B={BATCH} (CUDA events, same "
          f"phase): {json.dumps({k: round(v, 3) for k, v in routes.items()})}",
          time.perf_counter())

    # ---- 62. ProHMR-Scene with the camera switches off, the glow without batch norm
    t = time.perf_counter()
    off = dict(with_focal_length=False, with_bbox_info=False, with_cam_center=False)
    p_cfg = ProHMRConfig(**off, use_batch_norm=False)
    model = ProHMRScene(p_cfg, smpl, device=dev, seed=SEED)
    perturb_parameters_(model, torch.Generator().manual_seed(SEED + 83))
    randomize_batch_stats_(model, torch.Generator().manual_seed(SEED + 84))
    require(not any("batch_norm_layers" in k for k in model.state_dict())
            and p_cfg.total_context == 2048 + 512, f"ProHMR switches: context {p_cfg.total_context}")
    dm = images.EgoHmrImageDataModule(n_pts=HMR_POINTS, img_size=224, smpl=smpl)
    big_np = next(dm.batches("train", BATCH, shuffle=False))
    hmr_batch = to_torch(big_np, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 85)
    with torch.no_grad():
        out, counts = counted(lambda: model.forward_step(hmr_batch, generator=gen))
        require(counts == pointnet_256, f"ProHMR switches launch counts {counts}")
        record("prohmr_switches_eval", counts)
        for k, v in out.items():
            require(bool(torch.isfinite(v.float()).all()), f"ProHMR switches {k} not finite")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: model.forward_step(hmr_batch, generator=gen), 3)
        peak = torch.cuda.max_memory_allocated()
        cpu = ProHMRScene(p_cfg, smpl, device="cpu", seed=SEED)
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        small_np = next(images.EgoHmrImageDataModule(n_pts=512, img_size=224, smpl=smpl)
                        .batches("test", 2, shuffle=False))
        noise = torch.randn(2, p_cfg.num_test_samples - 1, p_cfg.flow_dim,
                            generator=torch.Generator().manual_seed(SEED + 86))
        ref = cpu.forward_step(to_torch(small_np, "cpu"), noise=noise)
        got = model.forward_step(to_torch(small_np, dev), noise=noise.to(dev))
    for k in ("pose_6d", "log_prob", "betas", "cam", "pred_keypoints_3d", "pred_vertices",
              "pred_cam_t_full", "pred_keypoints_2d_full", "conditioning_feats"):
        compare(f"ProHMR switches {k}, card vs CPU", got[k].cpu(), ref[k],
                float(ref[k].abs().max()), SLICE_RTOL)
    del model, cpu, out, got, ref
    torch.cuda.empty_cache()
    phase(f"ProHMR-Scene with the camera switches off and no glow batch norm (context "
          f"{p_cfg.total_context}): forward_step B={BATCH}, {HMR_POINTS} points: launches "
          f"{counts}, {ms:.3f} ms, peak {peak} B; card vs CPU (B=2, 512 points) agrees", t)

    # ---- 63. an EgoHMR training step with the switches off and the whole condition masked
    t = time.perf_counter()
    e_cfg = EgoHmrConfig(**off, only_mask_img_cond=False)
    model = EgoHmr(e_cfg, smpl, device=dev, seed=SEED)
    perturb_parameters_(model, torch.Generator().manual_seed(SEED + 87))
    randomize_batch_stats_(model, torch.Generator().manual_seed(SEED + 88))
    args = train_prohmr.parse_args(["--lr", str(TRAIN_LR)])
    cli_np = next(images.EgoHmrImageDataModule(n_pts=args.scene_points, img_size=224, smpl=smpl)
                  .batches("train", args.batch_size, shuffle=False, augment=True))
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    runs = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        m = EgoHmr(e_cfg, smpl, device=device)
        m.load_state_dict({k: v.to(device) for k, v in sd.items()})
        m.requires_grad_(True)
        runs[where] = (m, train_egohmr.adamw(m.parameters(), args))
    draws = runs["cpu"][0].train_draws(args.batch_size, torch.Generator().manual_seed(SEED + 89))
    draws["drop"][0] = True  # one sample's whole condition dropped
    losses, masks = {}, []
    for where, (m, opt) in runs.items():
        b = train_egohmr.add_body_rep(m, to_torch(cli_np, m.device))
        with relu_decisions(m, masks, record=where == "card"):
            losses[where] = float(train_egohmr.train_step(
                m, opt, b, {k: v.to(m.device) for k, v in draws.items()})["total"])
    compare_step("EgoHMR switches step", runs["cpu"][0], runs["card"][0], losses["cpu"],
                 losses["card"], TRAIN_LR)
    del runs
    model.requires_grad_(True)
    opt = train_egohmr.adamw(model.parameters(), args)
    ego_batch = train_egohmr.add_body_rep(model, hmr_batch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)

    def steps(n):
        for _ in range(n):
            train_egohmr.train_step(model, opt, ego_batch, model.train_draws(BATCH, gen))
        torch.cuda.synchronize()

    _, counts = counted(lambda: steps(1))
    require(counts == pointnet_256, f"EgoHMR switches step launch counts {counts}")
    record("egohmr_switches_train", counts)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps(3)
    ms = 1e3 * (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    del model, opt, ego_batch, hmr_batch
    torch.cuda.empty_cache()
    phase(f"EgoHMR training with the camera switches off and only_mask_img_cond=False (context "
          f"{e_cfg.context_dim}): card vs CPU at B={args.batch_size}, {args.scene_points} points "
          f"agrees; at B={BATCH}, {HMR_POINTS} points: launches {counts} a step, {ms:.3f} ms a "
          f"step (host clock), peak {peak} B", t)

    # ---- 64. TRAIN.RESUME on the --cfg route
    t = time.perf_counter()
    exp = os.path.join(work, "resume")
    vae_yaml = os.path.join(configs, "config_vae_egobody.yaml")
    keys = ["DEBUG=true", "LOGGER.SACE_CHECKPOINT_EPOCH=1"]
    first = train_main(["--cfg", vae_yaml, "--out", exp, "--epochs", "1", *keys])
    ckpt = os.path.join(exp, "checkpoints")
    saved = sorted(os.listdir(ckpt))
    require(saved == [f"{first.step}.pt"], f"resume: the first run saved {saved}")
    try:
        train_main(["--cfg", vae_yaml, "--out", exp, "--epochs", "3", *keys,
                    f"TRAIN.RESUME={exp}_mistyped"])
        raised = False
    except FileNotFoundError as e:
        raised = "TRAIN.RESUME" in str(e)
    require(raised and sorted(os.listdir(ckpt)) == saved,
            f"resume: a mistyped TRAIN.RESUME left {sorted(os.listdir(ckpt))}")
    resumed = train_main(["--cfg", vae_yaml, "--out", exp, "--epochs", "3", *keys,
                          f"TRAIN.RESUME={exp}"])
    after = sorted(os.listdir(ckpt))
    require(resumed.start_epoch == 1 and resumed.history[0]["epoch"] == 1
            and resumed.step == 3 * first.step and set(saved) < set(after),
            f"resume: start epoch {resumed.start_epoch}, step {resumed.step}, files {after}")
    require(all(math.isfinite(v) for r in resumed.history for v in r["means"].values()),
            "resume: losses not finite")
    phase(f"--cfg config_vae_egobody.yaml TRAIN.RESUME=<exp dir> on the card: resumed at step "
          f"{first.step} (epoch 1) to step {resumed.step}, step files {saved} -> {after} (none "
          f"deleted); a mistyped TRAIN.RESUME raised FileNotFoundError and left {saved}", t)


def shard_record(dev) -> dict:
    """Phase 60's `shard_params` step on a (1, 2) mesh, on this rank:
    `SeeMeConfig()` at full width (dropout 0), a batch of 64 with 20 000
    points (the raw scene, so the PointNet kernels run on gathered
    weights), one stage-2 AdamW step under DDP over the data-axis group,
    against the same step with the parameters replicated; kernel 3's
    sample before sharding, from the gathered operands, and after the
    step. Returns the agreements, storage and moment counts, launches and
    ms."""
    import torch

    from seeme_tpu_torch.core.smpl import synthetic_smpl
    from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
    from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
    from seeme_tpu_torch.nn.init import perturb_parameters_
    from seeme_tpu_torch.ops import denoiser_fused as dfu
    from seeme_tpu_torch.ops import module_state
    from seeme_tpu_torch.ops import pointnet_fused as pfu
    from seeme_tpu_torch.parallel import infer_param_shardings, make_mesh, shard_params
    from seeme_tpu_torch.parallel.mesh import batch_sharding, replicated, rows
    from seeme_tpu_torch.train.loop import StageLoss, train_step
    from seeme_tpu_torch.train.state import make_optimizer

    counters = counter_table(pfu, dfu)
    mesh = make_mesh(model_axis=2, device_type="cuda")
    shard = batch_sharding(mesh)
    cfg = dataclasses.replace(SeeMeConfig(), dropout=0.0)
    data = SyntheticEgoDataset(BATCH, cfg.motion_length, scene_points=cfg.scene_points, seed=SEED)
    smpl = synthetic_smpl(n_verts=6890, seed=SEED)
    batch = {k: rows(v, shard) for k, v in to_torch(data.batch(0, BATCH), dev).items()}
    z0 = rows(torch.randn(BATCH, 1, cfg.latent_dim[-1],
                          generator=torch.Generator().manual_seed(SEED + 60)), shard).to(dev)

    def fresh():
        system = SeeMeSystem(cfg, smpl, data.mean, data.std, device=dev, seed=SEED)
        perturb_parameters_(system, torch.Generator().manual_seed(SEED + 61))
        return system

    def step(system):
        optimizer, schedule = make_optimizer("diffusion", system, lr=TRAIN_LR)
        model = replicated(StageLoss(system, "diffusion"), dev, group=mesh.get_group("data"))
        draws = system.loss_draws("diffusion", batch,
                                  torch.Generator(device=dev).manual_seed(SEED + 62), shard=shard)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        terms = train_step(system, "diffusion", optimizer, schedule, 0, batch, draws=draws,
                           model=model)
        end.record()
        end.synchronize()
        return optimizer, terms["total"], start.elapsed_time(end)

    def sample(system):
        zero_counters(counters, pfu)
        z = system.sample_from_cond(system.encode_conditioning(batch), z_init=z0)
        torch.cuda.synchronize()
        return z, read_counters(counters, pfu, dfu)

    twin = fresh()
    _, twin_loss, twin_ms = step(twin)
    twin_after, _ = sample(twin)
    system = fresh()
    before, _ = sample(system)
    sharded = sorted(n for n, d in infer_param_shardings(system, mesh).items() if d is not None)
    whole = dict(system.named_parameters())
    whole_numel = {n: whole[n].numel() for n in sharded}
    shard_params(system, mesh)
    gathered, counts = sample(system)
    stored = sum(p.numel() for n, p in system.named_parameters() if ".parametrizations." in n)
    optimizer, loss, ms = step(system)
    after, _ = sample(system)
    moments = trained = 0
    for n, p in system.named_parameters():
        state = optimizer.state.get(p, {})
        if ".parametrizations." in n and "exp_avg" in state:
            moments += state["exp_avg"].numel()
            trained += whole_numel[n.replace(".parametrizations.", ".").replace(".original", "")]
    worst = 0.0
    twin_sd = twin.state_dict()
    for k, v in module_state(system).items():
        want = twin_sd[k]
        worst = max(worst, float((v - want).abs().max()) / max(float(want.abs().max()), 1e-30))
    scale = float(twin_after.abs().max())
    return {"shard": list(shard), "sharded": len(sharded), "params": len(whole),
            "stored": stored, "whole": sum(whole_numel.values()), "moments": moments,
            "trained": trained, "loss": loss, "twin_loss": twin_loss, "param_rel": worst,
            "gathered_bitwise": bool(torch.equal(gathered, before)),
            "gathered_rel": float((gathered - before).abs().max()) / float(before.abs().max()),
            "after_rel": float((after - twin_after).abs().max()) / scale,
            "moved": float((after - gathered).abs().max()) / scale, "counts": counts,
            "ms": ms, "twin_ms": twin_ms}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(sys.argv[2], sys.argv[3], sys.argv[4:])
        sys.exit(0)
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
