#!/usr/bin/env python3
"""Drive the PyTorch port's sampling paths on one NVIDIA GPU: EgoBody
(SEE-ME) and HumanML3D text-to-motion.

    python3 chip_smoke.py

Phases, each printing one line with its seconds as soon as it ends:
  1. the card: `nvidia-smi` name and power limit, `torch.cuda.get_device_name`;
  2. the nvcc build of `seeme_tpu_torch/csrc/*.cu` (one nvcc per source, in
     parallel);
  3. each CUDA kernel against its plain PyTorch version at its path's
     shapes (PointNet blocks at B=64, N=20 000, H=512; the MD DDIM-50 kernel
     at B=64, guidance 1.0 and 2.5, and its grid entry at both; the token
     DDIM-50 kernel at the T2M width, B=64, guidance 1.0 and 7.5): max-abs
     and relative error against the stated tolerance, the kernel's and the
     plain version's ms (CUDA events, after a warm-up), and the least time
     the card could take (bound_ms);
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
     joints' gap split into the RIC recovery's own and the features' carried.
Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, `{"ok": true, "device": {...}}`. Any failed check exits non-zero
at once. Random weights: the seeded init plus a seeded perturbation, so the
zero-initialized output projections carry signal.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

BATCH = 64
SEED = 0
PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
POINTNET_RTOL = 1e-4     # max |kernel - plain| / max |plain|
DDIM_RTOL = 1e-3         # max |kernel - plain| / max |z|
SLICE_RTOL = 1e-3        # card slice vs CPU slice (or grid vs loop), relative to max |features|

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


def compare(name: str, got, want, scale: float, rtol: float) -> float:
    import torch

    require(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    err = float((got - want).abs().max())
    ok = err <= rtol * scale
    print(f"    {name}: max_abs_err {err:.3e}, relative {err / scale:.3e} "
          f"(tolerance {rtol:.0e} x {scale:.4g}) {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name} disagrees with its plain version")
    return err


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
          f"x{torch.cuda.device_count()}", t)

    # ---- 2. build
    t = time.perf_counter()
    _build.load_library()
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
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
    out_k, pool_k = pfu.fused_input_block(*in_args)
    out_p, pool_p = pfu.fused_input_block_plain(*in_args)
    torch.cuda.synchronize()
    scale = float(out_p.abs().max())
    err = max(compare("input block out", out_k, out_p, scale, POINTNET_RTOL),
              compare("input block pool", pool_k, pool_p, scale, POINTNET_RTOL))
    del out_k, pool_k
    ms = time_ms(lambda: pfu.fused_input_block(*in_args), 3)
    plain_ms = time_ms(lambda: pfu.fused_input_block_plain(*in_args), 3)
    macs = B * N * (3 * 2 * H + 2 * H * H + H * H + 2 * H * H)
    nbytes = 4 * (points.numel() + sum(x.numel() for x in in_args[1:]) + B * N * H + B * H)
    kernels.append(dict(name="pointnet_input_block", route="cuda",
                        source="seeme_tpu_torch/csrc/pointnet.cu",
                        replaces="seeme_tpu/ops/pointnet_pallas.py:112",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=2 * macs))
    phase(f"kernel pointnet_input_block (B={B}, N={N}, H={H}): {ms:.3f} ms, plain {plain_ms:.3f} ms", t)

    t = time.perf_counter()
    sp_args = (out_p, pool_p, *(pw[f"block_1.{n}"]
                                for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")))
    out_k, pool_k = pfu.fused_split_block(*sp_args)
    out_s, pool_s = pfu.fused_split_block_plain(*sp_args)
    torch.cuda.synchronize()
    scale = float(out_s.abs().max())
    err = max(compare("split block out", out_k, out_s, scale, POINTNET_RTOL),
              compare("split block pool", pool_k, pool_s, scale, POINTNET_RTOL))
    del out_k, pool_k, out_s, pool_s
    ms = time_ms(lambda: pfu.fused_split_block(*sp_args), 3)
    plain_ms = time_ms(lambda: pfu.fused_split_block_plain(*sp_args), 3)
    macs = B * N * 3 * H * H + 2 * B * H * H
    nbytes = 4 * (sum(x.numel() for x in sp_args) + B * N * H + B * H)
    kernels.append(dict(name="pointnet_split_block", route="cuda",
                        source="seeme_tpu_torch/csrc/pointnet.cu",
                        replaces="seeme_tpu/ops/pointnet_pallas.py:56",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=2 * macs))
    phase(f"kernel pointnet_split_block (B={B}, N={N}, H={H}): {ms:.3f} ms, plain {plain_ms:.3f} ms", t)
    del out_p, pool_p, sp_args, in_args
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
        ms = time_ms(lambda: fn(*args, weights=weights), 3)
        plain_ms = time_ms(lambda: dfu.ddim_fused_plain(*args), 2)
        flops = ddim_flops(sd, cfg.num_layers, c.shape[0], c.shape[1], steps)
        nbytes = 4 * (sum(v.numel() for v in sd.values()) + c.numel() + 2 * z0.numel() + 2 * steps)
        phase(f"kernel ddim_md_t1 via {label} (B={B}, {steps} steps): {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms(flops, nbytes):.4f} ms", t)
        t = time.perf_counter()
        if name:
            kernels.append(dict(name=name, route="cuda", source="seeme_tpu_torch/csrc/ddim_md.cu",
                                replaces="seeme_tpu/ops/denoiser_fused.py:"
                                + ("597" if name == "ddim_md_t1" else "757"),
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                flops=flops))

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
                                source="seeme_tpu_torch/csrc/ddim_tok.cu",
                                replaces="seeme_tpu/ops/denoiser_fused.py:597",
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                flops=flops))
    del z_k, z_p

    counters = {"pointnet_input_block": pfu.fused_input_block,
                "pointnet_split_block": pfu.fused_split_block, "ddim_md_t1": dfu.ddim_fused,
                "ddim_fused_grid": dfu.ddim_fused_grid, "ddim_tok_t1": dfu.ddim_fused_tok}

    def counted(run):
        """Run with every launch count set to 0 just before; return the
        result and the counts read just after."""
        for fn in counters.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {name: fn.launches for name, fn in counters.items()}

    launches = {}

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
    expected = {"pointnet_input_block": 1, "pointnet_split_block": 3, "ddim_md_t1": 1,
                "ddim_fused_grid": 0, "ddim_tok_t1": 0}
    require(counts == expected, f"launch counts {counts}")
    for k in ("pointnet_input_block", "pointnet_split_block", "ddim_md_t1"):
        launches[k] = counts[k]
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

    for k in kernels:
        flops, nbytes = k.pop("flops"), k.pop("bytes")
        k["launches"] = launches[k["name"]]
        k["bound_ms"] = bound_ms(flops, nbytes)
        k["bound_by"] = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        k["library_ms"] = None  # no single PyTorch call computes any of these functions
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi --query-gpu=name,power.limit --format=csv,noheader gives it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the f32 peak or
    bytes at the HBM rate, whichever is longer."""
    return 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def ddim_flops(sd, num_layers: int, rows: int, n_cond: int, steps: int) -> float:
    """Operations of one `ddim_fused` call from the weight shapes: the
    per-window precompute (condition and time-token projections) plus every
    step's latent-row work (`seeme_tpu/ops/denoiser_fused.py:864-925`)."""
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
        step = 3 * proj + 4.0 * D * (n_cond + 2) + wf(f"{sa}.self_attn.out_proj.weight")
        step += wf(f"{sa}.linear1.weight") + wf(f"{sa}.linear2.weight")
        step += wf(f"{ca}.query.weight") + 4.0 * D * n_cond
        step += wf(f"{ca}.proj_out.out_layers.2.weight")
        step += wf(f"{ffn}.linear1.weight") + wf(f"{ffn}.linear2.weight")
        step += wf(f"{ffn}.proj_out.out_layers.2.weight")
        total += steps * rows * step
    for j in range((num_layers - 1) // 2):
        total += steps * rows * wf(f"encoder.linear_blocks.{j}.weight")
    return total


def tok_flops(sd, num_layers: int, rows: int, n_cond: int, steps: int) -> float:
    """Operations of one `ddim_fused_tok` call from the weight shapes: the
    per-window precompute (condition projection, every step's time token)
    plus every step's work on all S = n_cond + 2 token rows of each of the
    `rows` sequences (uncond and cond count apart), the token-path
    counterpart of `seeme_tpu/ops/denoiser_fused.py:864-925`."""
    from seeme_tpu_torch.ops.denoiser_fused import layer_names

    def wf(name):  # flops per row through a Linear weight (out, in)
        w = sd[name]
        return 2.0 * w.shape[0] * w.shape[1]

    D = sd["encoder.norm.weight"].shape[0]
    S = n_cond + 2
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
