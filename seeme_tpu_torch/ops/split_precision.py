"""How far each tensor-core operand scheme lands from the f32 PointNet blocks.

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
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List

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


def _split_tf32(t: torch.Tensor):
    hi = _tf32(t, True)
    return hi, _tf32(t - hi, True)


SCHEMES: Dict[str, Callable] = {
    "tf32": _one_pass(lambda t: _tf32(t, True)),
    "tf32_truncated": _one_pass(lambda t: _tf32(t, False)),
    "bf16": _one_pass(_bf16),
    "split_bf16": _split(lambda t: tuple(x.float() for x in split_bf16(t))),
    "split_tf32": _split(_split_tf32),
}
SPLIT = ("split_bf16", "split_tf32")  # the schemes of three products


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


def main(argv=None) -> None:
    from ..nn.init import init_parameters_, perturb_parameters_
    from ..nn.pointnet import ResnetPointnet

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--points", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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
