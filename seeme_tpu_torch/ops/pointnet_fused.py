"""Fused PointNet blocks (`seeme_tpu/ops/pointnet_pallas.py`).

`fused_input_block` and `fused_split_block` launch the CUDA kernels of
`csrc/pointnet.cu` for CUDA tensors and run their plain PyTorch versions
(`*_plain`) for CPU tensors. Weights are (in, out), as in the JAX package.
Each wrapper counts its kernel launches in `.launches`, and by hidden width
in `.launches_by_width`. `FusedPointnet` runs a whole `ResnetPointnet`
through them and keeps its kernel-layout weights while the encoder is
unchanged; it is differentiable, as the JAX package's `custom_vjp` is: the
backward recomputes the module's eager forward in chunks of 16 rows and
takes its VJP (cuBLAS on the card), with no kernel of its own. Both kernels are instantiated at hidden width
H = 512 (EgoBody's scene encoder, 64 points a CTA) and H = 256 (the
ProHMR-Scene and EgoHMR scene encoders, 128 points a CTA); the wrappers
refuse any other width on the card.

The kernels run every product as three bf16 tensor-core products of split
operands (`split_bf16`): the weights' hi/lo pairs come in `split`, made once
per module version by `pointnet_weights`, and the activations are split
inside the kernel.

The per-batch pool over tiles is one `amax` outside the kernel, and so are
the per-batch folds c0 = relu(pooled) W0p + b0 and cs = pooled Wsp + b1 and
the final `fc_c`, as the JAX wrapper does them outside its kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build, tensor_versions

TILE = {256: 128, 512: 64}  # the widths `csrc/pointnet.cu` instantiates: points a CTA
WIDTHS = tuple(TILE)
INPUT_SPLIT = ("w0", "w1", "ws")     # the product weights each kernel reads split,
BLOCK_SPLIT = ("w0x", "w1", "wsx")   # in the order of its `split` argument


def split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t = hi + lo to about 2^-16 relative: hi = bf16(t), lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def split_weight(w: torch.Tensor) -> torch.Tensor:
    """The kernels' operand of an (in, out) weight: its (out, in) transpose
    (nn.Linear's layout, K-major for the tensor cores) split by `split_bf16`,
    hi rows over lo rows, cut into K steps of 16 columns. Each step's
    (2 out, 16) block is contiguous and in wgmma's 32-byte swizzle (the two
    16-byte halves of a row swap where bit 2 of the row is set), so that one
    bulk copy moves it into shared memory as the products read it:
    (in / 16, 2 out, 16) bf16."""
    s = torch.cat(split_bf16(w.t()))
    rows, k = s.shape
    t = s.reshape(rows, k // 16, 2, 8).permute(1, 0, 2, 3)
    swap = ((torch.arange(rows, device=s.device) >> 2) & 1).bool()[None, :, None, None]
    return torch.where(swap, t.flip(2), t).reshape(k // 16, rows, 16).contiguous()


def fused_input_block_plain(points, wpos, bpos, w0, b0, w1, b1, ws):
    """(B, N, 3) points -> (block_0 output (B, N, H), its max over N (B, H))."""
    h = points @ wpos + bpos
    net = F.relu(h) @ w0 + b0
    out = h @ ws + F.relu(net) @ w1 + b1
    return out, out.amax(dim=1)


def fused_split_block_plain(x, pooled, w0x, w0p, b0, w1, b1, wsx, wsp):
    """SplitResnetBlockFC over [x; pooled] -> (out (B, N, H), its max (B, H))."""
    c0 = F.relu(pooled) @ w0p + b0
    cs = pooled @ wsp + b1
    net = F.relu(x) @ w0x + c0[:, None]
    out = x @ wsx + F.relu(net) @ w1 + cs[:, None]
    return out, out.amax(dim=1)


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        kind = str(dtype).replace("torch.", "")
        raise ValueError(f"{name}: needs a contiguous {kind} tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_split(name: str, split, shapes, device) -> None:
    """The split weights (`split_weight`) a kernel reads in place of the f32
    product weights."""
    if split is None or len(split) != len(shapes):
        raise ValueError(f"{name}: needs the {len(shapes)} split bf16 product weights "
                         f"(`pointnet_weights`), got {split!r:.80}")
    for i, (t, shape) in enumerate(zip(split, shapes)):
        _check(f"{name} split[{i}]", t, shape, device, torch.bfloat16)


def _check_width(name: str, H: int) -> None:
    if H not in TILE:
        raise ValueError(f"{name}: hidden width {H} is not one of {WIDTHS}")


def _tile_max(B: int, N: int, H: int, dev) -> torch.Tensor:
    """The kernels' per-tile column maxima, (B, tiles, H): a tile is the
    points one CTA takes at this width."""
    return torch.empty(B, (N + TILE[H] - 1) // TILE[H], H, device=dev)


def launch_info(input_block: bool, hidden: int = 512) -> Dict[str, int]:
    """The launch a kernel makes at hidden width `hidden`, asked of the CUDA
    runtime without launching: points a CTA, CTAs a cluster, ring slots,
    bytes a slot, dynamic shared memory bytes a CTA, clusters that fit at
    once."""
    _check_width("launch_info", hidden)
    info = (ctypes.c_int * 6)()
    _build.check(_build.load_library().pointnet_info(int(input_block), hidden, info),
                 "pointnet_info")
    return dict(zip(("tile", "cluster", "stages", "slot_bytes", "smem_bytes",
                     "active_clusters"), info))


def fused_input_block(points, wpos, bpos, w0, b0, w1, b1, ws, split=None):
    """`fused_input_block_plain` on the CPU; on the card the kernel, which
    reads `split` = (w0, w1, ws) through `split_weight` in place of the f32
    product weights."""
    if points.device.type == "cpu":
        return fused_input_block_plain(points, wpos, bpos, w0, b0, w1, b1, ws)
    B, N, _ = points.shape
    H = w1.shape[-1]
    _check_width("fused_input_block", H)
    dev = points.device
    for name, t, shape in (("points", points, (B, N, 3)), ("wpos", wpos, (3, 2 * H)),
                           ("bpos", bpos, (2 * H,)), ("w0", w0, (2 * H, H)), ("b0", b0, (H,)),
                           ("w1", w1, (H, H)), ("b1", b1, (H,)), ("ws", ws, (2 * H, H))):
        _check(name, t, shape, dev)
    _check_split("fused_input_block", split,
                 ((2 * H // 16, 2 * H, 16), (H // 16, 2 * H, 16), (2 * H // 16, 2 * H, 16)), dev)
    lib = _build.load_library()
    out = torch.empty(B, N, H, device=dev)
    tile_max = _tile_max(B, N, H, dev)
    s0, s1, ss = split
    fused_input_block.launches += 1
    fused_input_block.launches_by_width[H] += 1
    _build.check(lib.pointnet_input_block(
        points.data_ptr(), wpos.data_ptr(), bpos.data_ptr(), s0.data_ptr(), b0.data_ptr(),
        s1.data_ptr(), b1.data_ptr(), ss.data_ptr(), out.data_ptr(), tile_max.data_ptr(),
        B, N, H, _build.stream_ptr(dev)), "pointnet_input_block")
    return out, tile_max.amax(dim=1)


fused_input_block.launches = 0
fused_input_block.launches_by_width = dict.fromkeys(WIDTHS, 0)


def fused_split_block(x, pooled, w0x, w0p, b0, w1, b1, wsx, wsp, split=None):
    """`fused_split_block_plain` on the CPU; on the card the kernel, which
    reads `split` = (w0x, w1, wsx) through `split_weight` in place of the
    f32 product weights."""
    if x.device.type == "cpu":
        return fused_split_block_plain(x, pooled, w0x, w0p, b0, w1, b1, wsx, wsp)
    B, N, H = x.shape
    _check_width("fused_split_block", H)
    dev = x.device
    for name, t, shape in (("x", x, (B, N, H)), ("pooled", pooled, (B, H)),
                           ("w0x", w0x, (H, H)), ("w0p", w0p, (H, H)), ("b0", b0, (H,)),
                           ("w1", w1, (H, H)), ("b1", b1, (H,)), ("wsx", wsx, (H, H)),
                           ("wsp", wsp, (H, H))):
        _check(name, t, shape, dev)
    _check_split("fused_split_block", split, ((H // 16, 2 * H, 16),) * 3, dev)
    c0 = (F.relu(pooled) @ w0p + b0).contiguous()
    cs = (pooled @ wsp + b1).contiguous()
    lib = _build.load_library()
    out = torch.empty(B, N, H, device=dev)
    tile_max = _tile_max(B, N, H, dev)
    s0, s1, ss = split
    fused_split_block.launches += 1
    fused_split_block.launches_by_width[H] += 1
    _build.check(lib.pointnet_split_block(
        x.data_ptr(), c0.data_ptr(), cs.data_ptr(), s0.data_ptr(), s1.data_ptr(),
        ss.data_ptr(), out.data_ptr(), tile_max.data_ptr(), B, N, H,
        _build.stream_ptr(dev)), "pointnet_split_block")
    return out, tile_max.amax(dim=1)


fused_split_block.launches = 0
fused_split_block.launches_by_width = dict.fromkeys(WIDTHS, 0)


@torch.no_grad()
def pointnet_weights(pointnet) -> Dict[str, torch.Tensor]:
    """The fused path's operands from a `nn.pointnet.ResnetPointnet`: every
    weight transposed to (in, out) and the [x; pooled] layers split by rows,
    each a fresh contiguous tensor; and the kernels' bf16 hi/lo pair of each
    product weight (`split_weight`) under `<name>.split`."""
    from ..nn.pointnet import split_block_weights

    c = lambda t: t.detach().contiguous().clone()  # noqa: E731
    h = pointnet.hidden_dim
    b0 = pointnet.block_0
    w = {
        "wpos": c(pointnet.fc_pos_0.weight.t()), "bpos": c(pointnet.fc_pos_0.bias),
        "w0": c(b0.fc_0.weight.t()), "b0": c(b0.fc_0.bias),
        "w1": c(b0.fc_1.weight.t()), "b1": c(b0.fc_1.bias),
        "ws": c(b0.shortcut.weight.t()),
        "fc_c_w": c(pointnet.fc_c.weight), "fc_c_b": c(pointnet.fc_c.bias),
    }
    for i in (1, 2, 3):
        names = ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")
        for n, t in zip(names, split_block_weights(getattr(pointnet, f"block_{i}"), h)):
            w[f"block_{i}.{n}"] = c(t)
    for name in (*INPUT_SPLIT, *(f"block_{i}.{n}" for i in (1, 2, 3) for n in BLOCK_SPLIT)):
        w[f"{name}.split"] = split_weight(w[name])
    return w


def pointnet_forward(weights: Dict[str, torch.Tensor], points: torch.Tensor) -> torch.Tensor:
    """Full ResnetPointnet forward through the fused blocks: (B, N, 3) -> (B, out)."""
    x, pooled = fused_input_block(
        points.contiguous(), weights["wpos"], weights["bpos"], weights["w0"], weights["b0"],
        weights["w1"], weights["b1"], weights["ws"],
        split=tuple(weights[f"{n}.split"] for n in INPUT_SPLIT))
    for i in (1, 2, 3):
        x, pooled = fused_split_block(
            x, pooled, *(weights[f"block_{i}.{n}"]
                         for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")),
            split=tuple(weights[f"block_{i}.{n}.split"] for n in BLOCK_SPLIT))
    return F.linear(F.relu(pooled), weights["fc_c_w"], weights["fc_c_b"])


BATCH_CHUNK = 16  # rows a recompute chunk takes (`pointnet_pallas.py:208-218`)


class _FusedPointnetFunction(torch.autograd.Function):
    """`pointnet_forward_pallas`'s `custom_vjp` (`seeme_tpu/ops/pointnet_pallas.py:178-197`):
    the forward through the fused blocks, the backward by recomputing the
    module's own eager forward (`nn/pointnet.py`, the counterpart of
    `_pointnet_forward_xla`) over chunks of `BATCH_CHUNK` rows and taking its
    VJP. The inputs after `points` are the module's parameters, so their
    gradients land on them."""

    @staticmethod
    def forward(ctx, pointnet, weights, points, *params):
        ctx.pointnet = pointnet
        ctx.save_for_backward(points, *params)
        return pointnet_forward(weights, points)

    @staticmethod
    def backward(ctx, grad):
        points, *params = ctx.saved_tensors
        names = [n for n, _ in ctx.pointnet.named_parameters()]
        want_points = ctx.needs_input_grad[2]
        leaves = [p.detach().requires_grad_(True) for p in params]
        grads = [torch.zeros_like(p) for p in params]
        point_grads = []
        with torch.enable_grad():
            for rows in torch.split(torch.arange(points.shape[0], device=points.device),
                                    BATCH_CHUNK):
                chunk = points[rows].detach().requires_grad_(want_points)
                out = torch.func.functional_call(ctx.pointnet, dict(zip(names, leaves)), (chunk,))
                inputs = leaves + [chunk] if want_points else leaves
                got = torch.autograd.grad(out, inputs, grad[rows])
                for acc, g in zip(grads, got):
                    acc += g
                if want_points:
                    point_grads.append(got[-1])
        return (None, None, torch.cat(point_grads) if want_points else None, *grads)


class FusedPointnet:
    """A `ResnetPointnet` forward through the fused blocks, with their
    kernel-layout weights made again whenever the encoder's tensors change
    (`load_state_dict`, a move, an in-place update such as an optimizer
    step). Differentiable: gradients reach the encoder's parameters and,
    where they require grad, the points (`_FusedPointnetFunction`)."""

    def __init__(self):
        self._key, self._weights = None, None

    def weights(self, pointnet) -> Dict[str, torch.Tensor]:
        """`pointnet_weights(pointnet)`, made afresh only when it changed."""
        key = tensor_versions(pointnet)
        if key != self._key:
            self._key, self._weights = key, pointnet_weights(pointnet)
        return self._weights

    def __call__(self, pointnet, points: torch.Tensor) -> torch.Tensor:
        return _FusedPointnetFunction.apply(pointnet, self.weights(pointnet), points.contiguous(),
                                            *pointnet.parameters())
