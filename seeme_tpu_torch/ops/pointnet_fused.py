"""Fused PointNet blocks (`seeme_tpu/ops/pointnet_pallas.py`).

`fused_input_block` and `fused_split_block` launch the CUDA kernels of
`csrc/pointnet.cu` for CUDA tensors and run their plain PyTorch versions
(`*_plain`) for CPU tensors. Weights are (in, out), as in the JAX package.
Each wrapper counts its kernel launches in `.launches`.

The per-batch pool over tiles is one `amax` outside the kernel, and so are
the per-batch folds c0 = relu(pooled) W0p + b0 and cs = pooled Wsp + b1 and
the final `fc_c`, as the JAX wrapper does them outside its kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import _build

TILE = 32  # points per CTA, `csrc/pointnet.cu`


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


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous float32 tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def fused_input_block(points, wpos, bpos, w0, b0, w1, b1, ws):
    if points.device.type == "cpu":
        return fused_input_block_plain(points, wpos, bpos, w0, b0, w1, b1, ws)
    B, N, _ = points.shape
    H = w1.shape[-1]
    if H != 512:
        raise ValueError(f"fused_input_block: hidden width {H} is not 512")
    dev = points.device
    for name, t, shape in (("points", points, (B, N, 3)), ("wpos", wpos, (3, 2 * H)),
                           ("bpos", bpos, (2 * H,)), ("w0", w0, (2 * H, H)), ("b0", b0, (H,)),
                           ("w1", w1, (H, H)), ("b1", b1, (H,)), ("ws", ws, (2 * H, H))):
        _check(name, t, shape, dev)
    n_tiles = (N + TILE - 1) // TILE
    out = torch.empty(B, N, H, device=dev)
    tile_max = torch.empty(B, n_tiles, H, device=dev)
    lib = _build.load_library()
    fused_input_block.launches += 1
    _build.check(lib.pointnet_input_block(
        points.data_ptr(), wpos.data_ptr(), bpos.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), ws.data_ptr(), out.data_ptr(), tile_max.data_ptr(),
        B, N, H, _build.stream_ptr(dev)), "pointnet_input_block")
    return out, tile_max.amax(dim=1)


fused_input_block.launches = 0


def fused_split_block(x, pooled, w0x, w0p, b0, w1, b1, wsx, wsp):
    if x.device.type == "cpu":
        return fused_split_block_plain(x, pooled, w0x, w0p, b0, w1, b1, wsx, wsp)
    B, N, H = x.shape
    if H != 512:
        raise ValueError(f"fused_split_block: hidden width {H} is not 512")
    dev = x.device
    for name, t, shape in (("x", x, (B, N, H)), ("pooled", pooled, (B, H)),
                           ("w0x", w0x, (H, H)), ("w0p", w0p, (H, H)), ("b0", b0, (H,)),
                           ("w1", w1, (H, H)), ("b1", b1, (H,)), ("wsx", wsx, (H, H)),
                           ("wsp", wsp, (H, H))):
        _check(name, t, shape, dev)
    c0 = (F.relu(pooled) @ w0p + b0).contiguous()
    cs = (pooled @ wsp + b1).contiguous()
    n_tiles = (N + TILE - 1) // TILE
    out = torch.empty(B, N, H, device=dev)
    tile_max = torch.empty(B, n_tiles, H, device=dev)
    lib = _build.load_library()
    fused_split_block.launches += 1
    _build.check(lib.pointnet_split_block(
        x.data_ptr(), c0.data_ptr(), cs.data_ptr(), w0x.data_ptr(), w1.data_ptr(),
        wsx.data_ptr(), out.data_ptr(), tile_max.data_ptr(), B, N, H,
        _build.stream_ptr(dev)), "pointnet_split_block")
    return out, tile_max.amax(dim=1)


fused_split_block.launches = 0


@torch.no_grad()
def pointnet_weights(pointnet) -> Dict[str, torch.Tensor]:
    """The fused path's operands from a `nn.pointnet.ResnetPointnet`: every
    weight transposed to (in, out) and the [x; pooled] layers split by rows,
    each a fresh contiguous tensor."""
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
    return w


def pointnet_forward(weights: Dict[str, torch.Tensor], points: torch.Tensor) -> torch.Tensor:
    """Full ResnetPointnet forward through the fused blocks: (B, N, 3) -> (B, out)."""
    x, pooled = fused_input_block(
        points.contiguous(), weights["wpos"], weights["bpos"], weights["w0"], weights["b0"],
        weights["w1"], weights["b1"], weights["ws"])
    for i in (1, 2, 3):
        x, pooled = fused_split_block(
            x, pooled, *(weights[f"block_{i}.{n}"]
                         for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")))
    return F.linear(F.relu(pooled), weights["fc_c_w"], weights["fc_c_b"])
