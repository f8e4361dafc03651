"""EgoHMR's reverse process on the card (`csrc/gcn.cu`). No TPU kernel's
counterpart: the JAX package leaves the GCN to XLA.

`gcn_fused(rb, x, t, eps)` runs one ancestral step x_t -> x_{t-1} of
`models/egohmr.py::EgoHmr.sample` (with `t` None, the fused prediction at
timestep 0 of its final forward) for the batch `rb` that `FusedGcn.batch`
starts. For CPU tensors that is the plain version `gcn_fused_plain`, the
eager composition of `EgoHmr._fused_x0` (`nn/gcn.py::ModulatedGCN`) and
`ddpm_step`; for CUDA tensors the kernels, 2 x gcn_layers + 2 launches a
call, counted in `gcn_fused.launches`, or a ValueError for a width they
refuse (a hidden width that is not a multiple of `CHANNELS`).

What the kernels read, made by `gcn_weights` once per set of weights
(`FusedGcn` makes them again when the model's tensors change):
  - each graph conv's symmetrized adjacency (A + A^T) / 2 of `adj + adj2`,
    its off-diagonal half then its diagonal (`adjacency_halves`);
  - each hidden conv's W[0], W[1] packed by column tiles of `CHANNELS`,
    h0 then h1 of the same channels, split into TF32 hi/lo slot images
    (`pack_weight`); the output conv's (H, 12) in f32;
  - each conv's bias and frozen batch norm as one scale and shift a channel
    (`fold_norm`); M as it is;
  - the DDPM coefficients of every respaced step, computed as `ddpm_step`
    computes them (`ddpm_table`);
  - the timestep's share of the input conv for every respaced step and for
    timestep 0, with the pose embedding's bias share (`in.time`), and the
    pose embedding folded into the input conv (`in.wx`, 6 x 2H).
Once a batch (`ReverseBatch`), two f32 products give the condition's share
of the input conv: the image block's (`img @ W_img`, taken by the
conditioned rows of visible joints) and the rest's (`rest @ W_rest`, both
branches; zero on the scene-only branch without `only_mask_img_cond`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build, tensor_versions
from .split_precision import split_tf32

JOINTS = 24
TILE_SAMPLES = 8                    # samples a row tile of the kernels
TILE_ROWS = JOINTS * TILE_SAMPLES   # 192
CHANNELS = 64                       # channels a CTA (GCN_CHANNELS in csrc/refusals.cuh)
KS = 8                              # K of one slot image: 32-byte rows of TF32


def row_tiles(samples: int) -> int:
    return -(-samples // TILE_SAMPLES)


def slot_images(t: torch.Tensor) -> torch.Tensor:
    """(..., R, K) f32 operand rows, K-major, as the kernels' slot images:
    K steps of `KS` columns, each (R, KS) step contiguous with the two
    16-byte halves of a row swapped where bit 2 of the row is set (wgmma's
    32-byte swizzle), so that one bulk copy moves a step into shared memory
    as the products read it: (..., K / KS, R, KS)."""
    *lead, R, K = t.shape
    t = t.reshape(*lead, R, K // KS, 2, KS // 2).movedim(-3, -4)
    swap = ((torch.arange(R, device=t.device) >> 2) & 1).bool()[:, None, None]
    return torch.where(swap, t.flip(-2), t).reshape(*lead, K // KS, R, KS).contiguous()


def pack_weight(W: torch.Tensor) -> torch.Tensor:
    """A hidden conv's (2, in, out) weights as the kernel streams them: for
    each tile of `CHANNELS` output channels, the transposed block [W[0] |
    W[1]] of those channels (h0 then h1, 2 CHANNELS rows of `in`) split by
    `split_tf32`, its hi rows over its lo rows, as slot images:
    (out / CHANNELS, in / 8, 4 CHANNELS, 8) f32."""
    _, n_in, n_out = W.shape
    Wt = W.transpose(1, 2).reshape(2, n_out // CHANNELS, CHANNELS, n_in)
    return slot_images(torch.cat(split_tf32(torch.cat([Wt[0], Wt[1]], dim=1)), dim=1))


def tile_rows(x: torch.Tensor) -> torch.Tensor:
    """(row tiles x 192, H) f32 rows as the kernels read a conv's input and
    write its output: each row tile's hi rows over its lo rows
    (`split_tf32`), as slot images: (tiles, H / 8, 2 x 192, 8) f32."""
    rows, H = x.shape
    return slot_images(torch.cat(split_tf32(x.reshape(rows // TILE_ROWS, TILE_ROWS, H)), dim=1))


def adjacency_halves(conv):
    """A graph conv's (adj * eye, adj * (1 - eye)) as
    `ModulatedGraphConv.forward` makes them: the diagonal (24,) and the
    off-diagonal half (24, 24)."""
    adj = conv.adj + conv.adj2
    adj = (adj.T + adj) / 2
    eye = torch.eye(adj.shape[0], device=adj.device)
    return torch.diagonal(adj * eye), adj * (1 - eye)


def fold_norm(block):
    """A `GraphConvBlock`'s conv bias and frozen batch norm as y = scale x +
    shift a channel."""
    bn = block.bn
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale + scale * block.gconv.bias


def ddpm_table(sched) -> torch.Tensor:
    """(S, 3) f32: each respaced step's [x0, x_t, noise] coefficients of
    `DiffusionSchedule.ddpm_step`, in its f32 arithmetic (the noise's is the
    variance's square root, which step 0 does not use)."""
    rows = []
    for t in range(sched.num_train_timesteps):
        acp_t = torch.tensor(float(sched.alphas_cumprod[t]))
        acp_prev = torch.tensor(float(sched.alphas_cumprod[t - 1]) if t > 0 else 1.0)
        beta_t = 1.0 - acp_t / acp_prev
        c_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
        c_xt = torch.sqrt(1.0 - beta_t) * (1.0 - acp_prev) / (1.0 - acp_t)
        variance = ((1.0 - acp_prev) / (1.0 - acp_t) * beta_t).clamp_min(1e-20)
        rows.append(torch.stack([c_x0, c_xt, torch.sqrt(variance)]))
    return torch.stack(rows)


def _flat(*ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts]).contiguous()


@torch.no_grad()
def gcn_weights(model) -> Dict[str, torch.Tensor]:
    """Every operand the kernels read that depends on the weights alone
    (the module docstring lists them); convs by index: 0 the input conv,
    then each residual block's two."""
    cfg, gcn, dev = model.cfg, model.diffusion_model, model.device
    H = cfg.gcn_hid_dim
    if dev.type == "cuda":
        _build.check(_build.load_library().gcn_widths(H), "gcn_fused", f"hidden width {H}")
    blocks = [gcn.gconv_input[0]] + [b for layer in gcn.gconv_layers
                                     for b in (layer.gconv1, layer.gconv2)]
    w = {}
    for i, block in enumerate(blocks):
        diag, off = adjacency_halves(block.gconv)
        w[f"conv{i}.adj"] = _flat(off, diag)
        w[f"conv{i}.m"] = block.gconv.M.detach().contiguous()
        scale, shift = fold_norm(block)
        w[f"conv{i}.scale"], w[f"conv{i}.shift"] = scale.contiguous(), shift.contiguous()
        if i > 0:
            w[f"conv{i}.w"] = pack_weight(block.gconv.W)
    out = gcn.gconv_output
    diag, off = adjacency_halves(out)
    w["out.adj"] = _flat(off, diag)
    w["out.m"] = out.M.detach().contiguous()
    w["out.bias"] = out.bias.detach().contiguous()
    w["out.w"] = torch.cat([out.W[0], out.W[1]], dim=1).contiguous()
    W = blocks[0].gconv.W                          # rows: [image | rest | pose | timestep]
    img, ctx, xd = cfg.img_feat_dim, cfg.context_dim, cfg.input_process_dim
    w["in.img"] = torch.cat([W[0, :img], W[1, :img]], dim=1).contiguous()
    w["in.rest"] = torch.cat([W[0, img:ctx], W[1, img:ctx]], dim=1).contiguous()
    W_x, W_t = W[:, ctx:ctx + xd], W[:, ctx + xd:]
    emb = model.input_process.poseEmbedding
    w["in.wx"] = torch.einsum("ed,kec->dkc", emb.weight, W_x).contiguous()
    S = model.sample_schedule.num_train_timesteps
    ts = torch.as_tensor([int(model.timestep_map[t]) for t in range(S)] + [0], device=dev)
    w["in.time"] = (torch.einsum("se,kec->skc", model.embed_timestep(ts), W_t)
                    + torch.einsum("e,kec->kc", emb.bias, W_x)).contiguous()
    w["coef"] = ddpm_table(model.sample_schedule).to(dev)
    return w


class ReverseBatch:
    """One batch's reverse process: the plain version's condition rows for
    CPU tensors; for CUDA tensors the kernels' operands (`weights`), the
    condition's share of the input conv and the activations' buffers."""

    def __init__(self, model, weights: Optional[Dict[str, torch.Tensor]], enc: Dict,
                 vis_mask: torch.Tensor):
        self.model, self.weights = model, weights
        self.B = B = vis_mask.shape[0]
        if weights is None:
            cond = model.conditioning(enc, vis_mask)
            self.cond, self.cond_uncond = cond, model.mask_cond(cond)
            self.vis6 = vis_mask.repeat_interleave(6, dim=-1)
            return
        cfg, dev = model.cfg, vis_mask.device
        self.H = H = cfg.gcn_hid_dim
        self.layers = cfg.gcn_layers
        self.p_img = (enc["img"] @ weights["in.img"]).reshape(B, 2, H)
        p_rest = (enc["rest"] @ weights["in.rest"]).reshape(B, 2, H)
        self.p_rest = torch.cat([p_rest, p_rest if cfg.only_mask_img_cond
                                 else torch.zeros_like(p_rest)])
        self.vis = vis_mask.to(torch.float32).contiguous()
        tiles = row_tiles(2 * B)
        self.xf = torch.empty(tiles * TILE_ROWS, H, device=dev)
        self.hl = [torch.empty(tiles, H // KS, 2 * TILE_ROWS, KS, device=dev) for _ in range(2)]


class FusedGcn:
    """A model's kernel operands (`gcn_weights`), made afresh only when the
    denoiser's tensors changed (`load_state_dict`, a move, an in-place
    update), and each batch's `ReverseBatch`."""

    def __init__(self):
        self._key, self._weights = None, None

    def weights(self, model) -> Dict[str, torch.Tensor]:
        key = tensor_versions(model.diffusion_model, model.embed_timestep, model.input_process)
        if key != self._key:
            self._key, self._weights = key, gcn_weights(model)
        return self._weights

    def batch(self, model, enc: Dict, vis_mask: torch.Tensor) -> ReverseBatch:
        weights = None if vis_mask.device.type == "cpu" else self.weights(model)
        return ReverseBatch(model, weights, enc, vis_mask)


def gcn_fused_plain(rb: ReverseBatch, x: torch.Tensor, t: Optional[int] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eager step: both branches' predictions through the module, fused
    by visibility, then `ddpm_step`; with `t` None the fused prediction at
    timestep 0."""
    model, B = rb.model, x.shape[0]
    if t is None:
        return model._fused_x0(rb.cond, rb.cond_uncond, rb.vis6, x,
                               torch.zeros(B, dtype=torch.long, device=x.device))
    model_t = torch.full((B,), int(model.timestep_map[t]), dtype=torch.long, device=x.device)
    pred = model._fused_x0(rb.cond, rb.cond_uncond, rb.vis6, x, model_t)
    return model.sample_schedule.ddpm_step(pred, t, x, eps)


def _check_state(name: str, t: torch.Tensor, B: int, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (B, JOINTS * 6):
        raise ValueError(f"gcn_fused: {name} must be ({B}, {JOINTS * 6}) float32 on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def gcn_fused(rb: ReverseBatch, x: torch.Tensor, t: Optional[int] = None,
              eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`gcn_fused_plain` for CPU tensors; for CUDA tensors the input conv,
    the hidden convs and the output kernel (which writes x_{t-1}, or the
    prediction when `t` is None)."""
    if x.device.type == "cpu":
        return gcn_fused_plain(rb, x, t, eps)
    w, B, H = rb.weights, rb.B, rb.H
    _check_state("x", x, B, rb.vis.device)
    x = x.contiguous()
    if eps is not None:
        _check_state("eps", eps, B, rb.vis.device)
        eps = eps.contiguous()
    lib = _build.load_library()
    stream = _build.stream_ptr(x.device)
    S = w["coef"].shape[0]
    trow = w["in.time"][S if t is None else t]
    a, h = rb.hl
    gcn_fused.launches += 2 * rb.layers + 2
    _build.check(lib.gcn_input(
        x.data_ptr(), rb.vis.data_ptr(), rb.p_img.data_ptr(), rb.p_rest.data_ptr(),
        trow.data_ptr(), w["in.wx"].data_ptr(), w["conv0.m"].data_ptr(),
        w["conv0.adj"].data_ptr(), w["conv0.scale"].data_ptr(), w["conv0.shift"].data_ptr(),
        rb.xf.data_ptr(), a.data_ptr(), B, H, stream), "gcn_input")
    tiles = a.shape[0]
    for i in range(1, 2 * rb.layers + 1):
        second = i % 2 == 0      # a residual block's second conv: adds and keeps the f32 rows
        src, dst = (h, a) if second else (a, h)
        f32 = rb.xf.data_ptr() if second else None
        _build.check(lib.gcn_conv(
            src.data_ptr(), w[f"conv{i}.w"].data_ptr(), w[f"conv{i}.m"].data_ptr(),
            w[f"conv{i}.adj"].data_ptr(), w[f"conv{i}.scale"].data_ptr(),
            w[f"conv{i}.shift"].data_ptr(), f32, f32, dst.data_ptr(), tiles, H, stream),
            "gcn_conv", f"hidden width {H}")
    out = torch.empty(B, JOINTS * 6, device=x.device)
    _build.check(lib.gcn_output(
        rb.xf.data_ptr(), w["out.w"].data_ptr(), w["out.m"].data_ptr(), w["out.adj"].data_ptr(),
        w["out.bias"].data_ptr(), rb.vis.data_ptr(), x.data_ptr(),
        None if eps is None else eps.data_ptr(),
        None if t is None else w["coef"][t].data_ptr(), out.data_ptr(), B, H, stream),
        "gcn_output")
    return out


gcn_fused.launches = 0
