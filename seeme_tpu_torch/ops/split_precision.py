"""How far each tensor-core operand scheme lands from the f32 PointNet blocks
and from EgoHMR's f32 reverse process.

The PointNet kernels (`csrc/pointnet.cu`) are held to their f32 plain
versions within 1e-4 of max|out|. This emulates on the CPU the operand
roundings of five ways to run the blocks' products on tensor cores, with f32
accumulation, and prints each block's error relative to the max |out| of its
f32 reference, every block fed the f32 reference's input:

    python -m seeme_tpu_torch.ops.split_precision [--hidden 512] [--points 4000] [--batch 2]

Schemes: one pass in TF32 rounded to nearest, in TF32 with the low bits
dropped (raw f32 fed to the tensor cores), in bf16; and three products of
split operands (hi hi + hi lo + lo hi) in bf16, the kernels' scheme, and in
TF32. The weights are the port's seeded init plus its seeded perturbation.

With `--gcn` it runs EgoHMR's whole sampling (`EgoHmr.sample`'s 50 ancestral
steps and the final prediction) at the published widths, once in f32 and
once for each split scheme in the hidden graph convs' weight products (the
products `csrc/gcn.cu` runs on tensor cores; the input conv, the output conv
and the adjacency mixes stay f32, as in the kernels), from the same features,
initial state and noise, and prints the final normalized pose's max |gap| /
max |f32 pose| a seed. The weights are drawn as `egohmr.test` draws them
(`draw_like_the_cell_`), the features encoded from the synthetic crops and
scenes of the test CLI:

    python -m seeme_tpu_torch.ops.split_precision --gcn [--seeds 8] [--batch 2]
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .pointnet_fused import pointnet_weights, split_bf16

BLOCKS = ("input", "split 1", "split 2", "split 3")


def _tf32(t: torch.Tensor, nearest: bool) -> torch.Tensor:
    """t with its mantissa cut to TF32's 10 bits, rounded to nearest even or
    truncated."""
    i = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if nearest:
        i = i + 0xFFF + ((i >> 13) & 1)
    i = i & 0xFFFFE000
    return (((i + 2**31) % 2**32) - 2**31).to(torch.int32).view(torch.float32)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _one_pass(rnd: Callable) -> Callable:
    return lambda a, w: rnd(a) @ rnd(w)


def _split(pair: Callable) -> Callable:
    def product(a, w):
        (a_hi, a_lo), (w_hi, w_lo) = pair(a), pair(w)
        return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi
    return product


def split_tf32(t: torch.Tensor):
    """t = hi + lo to about 2^-22 relative: hi = tf32(t), lo = tf32(t - hi),
    both rounded to nearest even and kept as f32."""
    hi = _tf32(t, True)
    return hi, _tf32(t - hi, True)


SCHEMES: Dict[str, Callable] = {
    "tf32": _one_pass(lambda t: _tf32(t, True)),
    "tf32_truncated": _one_pass(lambda t: _tf32(t, False)),
    "bf16": _one_pass(_bf16),
    "split_bf16": _split(lambda t: tuple(x.float() for x in split_bf16(t))),
    "split_tf32": _split(split_tf32),
}
SPLIT = ("split_bf16", "split_tf32")  # the schemes of three products
# a third of egohmr.test's pose limit (1e-4), which every seed's reading should
# stay under; the cell's own comparison, the widest gap over 192 samples a run
# and the features' gap besides, reads higher (PERF.md)
GCN_GATE = 3e-5


@torch.no_grad()
def block_errors(pointnet, points: torch.Tensor, scheme: str) -> List[float]:
    """max |block_scheme - block_f32| / max |block_f32| for the input block and
    the three split blocks, each on the f32 reference's input. The input
    embedding h, the pooled folds c0 and cs, and the biases stay f32, as in
    the kernels."""
    mm = SCHEMES[scheme]
    w = pointnet_weights(pointnet)
    h = points @ w["wpos"] + w["bpos"]
    ref = h @ w["ws"] + F.relu(F.relu(h) @ w["w0"] + w["b0"]) @ w["w1"] + w["b1"]
    got = mm(h, w["ws"]) + mm(F.relu(mm(F.relu(h), w["w0"]) + w["b0"]), w["w1"]) + w["b1"]
    errors = [float((got - ref).abs().max() / ref.abs().max())]
    x = ref
    for i in (1, 2, 3):
        b = {n: w[f"block_{i}.{n}"] for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")}
        pooled = x.amax(dim=1, keepdim=True)
        c0 = F.relu(pooled) @ b["w0p"] + b["b0"]
        cs = pooled @ b["wsp"] + b["b1"]
        ref = x @ b["wsx"] + F.relu(F.relu(x) @ b["w0x"] + c0) @ b["w1"] + cs
        got = mm(x, b["wsx"]) + mm(F.relu(mm(F.relu(x), b["w0x"]) + c0), b["w1"]) + cs
        errors.append(float((got - ref).abs().max() / ref.abs().max()))
        x = ref
    return errors


# ------------------------------------------------- EgoHMR's reverse process
ENCODERS = ("backbone.", "scene_enc.", "transl_enc.", "embed_timestep.", "input_process.",
            "diffusion_model.")


@torch.no_grad()
def draw_like_the_cell_(model, seed: int) -> None:
    """The encoders' and the GCN's tensors as `egohmr.test` draws them
    (`portbench/systems/__init__.py::make_weights`, then
    `portbench/systems/egohmr.py::redraw`): a matrix N(0, 1) / sqrt(its row
    length), a 1-D weight 1 + 0.1 N, any other 1-D tensor 0.1 N; then every
    batch norm's `running_var` 0.5 + U(0, 1), each graph conv's `W[k]`
    N(0, 1) / sqrt(2 in), `M` 1 + 0.1 N and `adj2` 0.01 N."""
    g = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        if not name.startswith(ENCODERS) or not t.is_floating_point():
            continue
        if name.endswith("running_var"):
            new = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith(".W"):
            new = torch.randn(t.shape, generator=g) / math.sqrt(2 * t.shape[1])
        elif name.endswith(".M"):
            new = 1.0 + 0.1 * torch.randn(t.shape, generator=g)
        elif name.endswith(".adj2"):
            new = 0.01 * torch.randn(t.shape, generator=g)
        elif t.ndim >= 2:
            new = torch.randn(t.shape, generator=g) / math.sqrt(math.prod(t.shape[1:]))
        else:
            new = 0.1 * torch.randn(t.shape, generator=g) + float(name.endswith("weight"))
        t.copy_(new)


def _graph_conv(conv, x: torch.Tensor, mm: Callable) -> torch.Tensor:
    """`nn/gcn.py::ModulatedGraphConv.forward` with its weight products through `mm`."""
    h0, h1 = mm(x, conv.W[0]), mm(x, conv.W[1])
    adj = conv.adj + conv.adj2
    adj = (adj.T + adj) / 2
    eye = torch.eye(adj.shape[0])
    return (adj * eye) @ (conv.M * h0) + (adj * (1 - eye)) @ (conv.M * h1) + conv.bias


def _conv_block(block, x: torch.Tensor, mm: Callable) -> torch.Tensor:
    h = _graph_conv(block.gconv, x, mm)
    return torch.relu(block.bn(h.reshape(-1, h.shape[-1])).reshape(h.shape))


def _fused_x0(model, cond, cond_uncond, vis6, x, t: int, mm: Callable) -> torch.Tensor:
    """`EgoHmr._fused_x0` with the hidden convs' products through `mm`."""
    B = x.shape[0]
    emb = model.input_process.poseEmbedding(x.reshape(B, 24, 6))
    t_emb = model.embed_timestep(torch.full((2 * B,), t))[:, None].expand(-1, 24, -1)
    gcn = model.diffusion_model
    h = gcn.gconv_input[0](torch.cat([torch.cat([cond, cond_uncond]), torch.cat([emb, emb]),
                                      t_emb], dim=-1))
    for layer in gcn.gconv_layers:
        h = h + _conv_block(layer.gconv2, _conv_block(layer.gconv1, h, mm), mm)
    pred, pred_uncond = gcn.gconv_output(h).reshape(2 * B, 144).chunk(2)
    return torch.where(vis6, pred, pred_uncond)


@torch.no_grad()
def reverse_pose(model, enc: Dict, vis_mask: torch.Tensor, draws: Sequence[torch.Tensor],
                 mm: Callable) -> torch.Tensor:
    """`EgoHmr.sample`'s normalized pose (B, 144): the ancestral steps from
    draws[0] with draws[1:] as their noise, then the fused prediction at t = 0."""
    cond = model.conditioning(enc, vis_mask)
    cond_uncond = model.mask_cond(cond)
    vis6 = vis_mask.repeat_interleave(6, dim=-1)
    sched = model.sample_schedule
    x = draws[0]
    for i, t in enumerate(range(sched.num_train_timesteps - 1, -1, -1)):
        pred = _fused_x0(model, cond, cond_uncond, vis6, x, int(model.timestep_map[t]), mm)
        x = sched.ddpm_step(pred, t, x, draws[i + 1] if t > 0 else None)
    return _fused_x0(model, cond, cond_uncond, vis6, x, 0, mm)


@torch.no_grad()
def gcn_errors(seed: int, batch: int, schemes: Sequence[str] = SPLIT) -> Dict[str, float]:
    """Each scheme's final pose gap, max |pose - f32 pose| / max |f32 pose|,
    for one seed's weights, crops, scenes and draws at the published widths."""
    from ..core.smpl import synthetic_smpl
    from ..data.egohmr_images import EgoHmrImageDataModule
    from ..data.synthetic import to_torch
    from ..models.egohmr import EgoHmr, EgoHmrConfig

    smpl = synthetic_smpl(n_verts=256)
    model = EgoHmr(EgoHmrConfig(), smpl, device="cpu", seed=seed)
    draw_like_the_cell_(model, seed)
    dm = EgoHmrImageDataModule(n_pts=20000, img_size=224, smpl=smpl)
    data = to_torch(next(dm.batches("test", batch, shuffle=True, seed=seed)), "cpu")
    enc = model.encode(data)
    vis = model.visibility_mask(data)
    g = torch.Generator().manual_seed(seed)
    draws = [torch.randn(batch, 144, generator=g)
             for _ in range(model.sample_schedule.num_train_timesteps + 1)]
    ref = reverse_pose(model, enc, vis, draws, torch.matmul)
    return {s: float((reverse_pose(model, enc, vis, draws, SCHEMES[s]) - ref).abs().max()
                     / ref.abs().max()) for s in schemes}


def main(argv=None) -> None:
    from ..nn.init import init_parameters_, perturb_parameters_
    from ..nn.pointnet import ResnetPointnet

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gcn", action="store_true",
                    help="EgoHMR's reverse process at the published widths instead")
    ap.add_argument("--seeds", type=int, default=8, help="with --gcn: seeds 0 .. seeds - 1")
    args = ap.parse_args(argv)
    if args.gcn:
        print(f"final pose: max |gap| / max |f32 pose|, B={args.batch}; the gate is {GCN_GATE:g}, "
              f"a third of the cell's pose limit")
        worst = dict.fromkeys(SPLIT, 0.0)
        for seed in range(args.seed, args.seed + args.seeds):
            errors = gcn_errors(seed, args.batch)
            worst = {s: max(worst[s], e) for s, e in errors.items()}
            print(f"seed {seed}: " + ", ".join(f"{s} {e:.3e}" for s, e in errors.items()),
                  flush=True)
        print("worst: " + ", ".join(f"{s} {e:.3e} ({'under' if e <= GCN_GATE else 'OVER'} the gate)"
                                    for s, e in worst.items()))
        return
    net = ResnetPointnet(out_dim=args.hidden, hidden_dim=args.hidden)
    init_parameters_(net, torch.Generator().manual_seed(args.seed))
    perturb_parameters_(net, torch.Generator().manual_seed(args.seed + 1))
    points = torch.randn(args.batch, args.points, 3,
                         generator=torch.Generator().manual_seed(args.seed + 2))
    print(f"error / max|out| per block ({', '.join(BLOCKS)}), H={args.hidden}, "
          f"B={args.batch}, N={args.points}; the kernels' gate is 1e-4")
    for scheme in SCHEMES:
        errors = block_errors(net, points, scheme)
        verdict = "under" if max(errors) < 1e-4 else "OVER"
        print(f"{scheme:>15}: {', '.join(f'{e:.2e}' for e in errors)}  ({verdict} 1e-4)")


if __name__ == "__main__":
    main()
