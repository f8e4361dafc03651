"""The DDIM reverse process in one CUDA launch (`seeme_tpu/ops/denoiser_fused.py`).

* `denoiser_apply_pure(sd, x, timesteps, cond)`: a plain twin of
  `models.denoiser.Denoiser` for one latent token (T=1), reading the
  denoiser's state dict, with the step-invariant condition projections
  hoisted (`md_step_invariants`). Single head, as the JAX twin.
* `ddim_fused_plain`: `diffusion/sampling.py::ddim_sample` (eta 0,
  epsilon prediction, CFG mix) over `denoiser_apply_pure`.
* `ddim_fused`: launches `csrc/ddim_md.cu` for CUDA tensors (all steps, all
  layers, the CFG mix and the DDIM update in one kernel), after the
  per-window precompute (`_window_precompute`, `md_step_invariants`) in
  PyTorch, as `ddim_fused_grid` does in XLA. For CPU tensors it runs
  `ddim_fused_plain`. Its launches are counted in `ddim_fused.launches`.

GELU is the exact erf form throughout, as in the flax `Denoiser`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..diffusion.sampling import ddim_sample
from ..diffusion.schedulers import DiffusionSchedule
from ..nn.embeddings import sinusoidal_timestep_embedding
from . import _build

StateDict = Dict[str, torch.Tensor]


def _lin(sd: StateDict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


def _ln(sd: StateDict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def _qkv(sd: StateDict, layer: str):
    """(w, b) pairs of the q, k, v projections of a layer's sa_block."""
    w = sd[f"{layer}.sa_block.self_attn.in_proj_weight"]
    b = sd[f"{layer}.sa_block.self_attn.in_proj_bias"]
    return tuple(zip(w.chunk(3), b.chunk(3)))


def layer_names(num_layers: int) -> List[str]:
    """MD layers in execution order: input blocks, middle, output blocks."""
    nb = (num_layers - 1) // 2
    return ([f"encoder.input_blocks.{i}" for i in range(nb)] + ["encoder.middle_block"]
            + [f"encoder.output_blocks.{i}" for i in range(nb)])


def md_step_invariants(sd: StateDict, xf: torch.Tensor, num_layers: int,
                       time_tokens: torch.Tensor | None = None) -> Dict[str, Dict]:
    """Step-invariant pieces of every MD layer (`denoiser_fused.py:156-202`):
    the condition rows' self-attention k/v, the cross-attention key (softmaxed
    over tokens) and value; with `time_tokens` (steps, D), also every step's
    time-token k/v and both stylization emb_linear rows."""
    inv = {}
    for name in layer_names(num_layers):
        (_, _), (wk, bk), (wv, bv) = _qkv(sd, name)
        ca = f"{name}.ca_block"
        xfn = _ln(sd, f"{ca}.text_norm", xf)
        d = {
            "k_xf": F.linear(xf, wk, bk),
            "v_xf": F.linear(xf, wv, bv),
            "ca_key": torch.softmax(_lin(sd, f"{ca}.key", xfn), dim=1),
            "ca_value": _lin(sd, f"{ca}.value", xfn),
        }
        if time_tokens is not None:
            se = F.silu(time_tokens)
            d["k_emb"] = F.linear(time_tokens, wk, bk)
            d["v_emb"] = F.linear(time_tokens, wv, bv)
            d["ca_eo"] = _lin(sd, f"{ca}.proj_out.emb_layers.1", se)
            d["ffn_eo"] = _lin(sd, f"{name}.ffn.proj_out.emb_layers.1", se)
        inv[name] = d
    return inv


def _stylization_eo(sd: StateDict, prefix: str, h: torch.Tensor, eo: torch.Tensor):
    scale, shift = eo[:, None, :].chunk(2, dim=-1)
    h = _ln(sd, f"{prefix}.norm", h) * (1 + scale) + shift
    return _lin(sd, f"{prefix}.out_layers.2", F.silu(h))


def _md_layer_t1(sd: StateDict, name: str, x: torch.Tensor, inv: Dict,
                 emb: torch.Tensor) -> torch.Tensor:
    """One MD layer for a single latent token (`denoiser_fused.py:213-281`).
    x (B, 1, D); emb (B, 1, D) is the time token."""
    (wq, bq), (wk, bk), (wv, bv) = _qkv(sd, name)
    D = x.shape[-1]
    k_e = F.linear(emb[:, 0], wk, bk)
    v_e = F.linear(emb[:, 0], wv, bv)
    se = F.silu(emb[:, 0])
    ca_eo = _lin(sd, f"{name}.ca_block.proj_out.emb_layers.1", se)
    ffn_eo = _lin(sd, f"{name}.ffn.proj_out.emb_layers.1", se)

    q_x = F.linear(x, wq, bq)
    k_x = F.linear(x, wk, bk)
    v_x = F.linear(x, wv, bv)
    l_x = (q_x * k_x).sum(-1)                                   # (B, 1)
    l_f = (q_x * inv["k_xf"]).sum(-1)                           # (B, N)
    l_e = (q_x[:, 0] * k_e).sum(-1, keepdim=True)               # (B, 1)
    attn = torch.softmax(torch.cat([l_x, l_f, l_e], dim=1) / math.sqrt(D), dim=-1)
    N = l_f.shape[1]
    out = (attn[:, :1] * v_x[:, 0] + (attn[:, 1:1 + N, None] * inv["v_xf"]).sum(1)
           + attn[:, 1 + N:] * v_e)
    sa = f"{name}.sa_block"
    out = _lin(sd, f"{sa}.self_attn.out_proj", out[:, None])
    x = _ln(sd, f"{sa}.norm1", x + out)
    h = _lin(sd, f"{sa}.linear2", F.relu(_lin(sd, f"{sa}.linear1", x)))
    x = _ln(sd, f"{sa}.norm2", x + h)

    ca = f"{name}.ca_block"
    query = torch.softmax(_lin(sd, f"{ca}.query", _ln(sd, f"{ca}.norm", x)), dim=-1)
    w = (query * inv["ca_key"]).sum(-1)                         # (B, N)
    y = (w[..., None] * inv["ca_value"]).sum(1, keepdim=True)   # (B, 1, D)
    x = x + _stylization_eo(sd, f"{ca}.proj_out", y, ca_eo)

    ffn = f"{name}.ffn"
    h = _lin(sd, f"{ffn}.linear2", F.gelu(_lin(sd, f"{ffn}.linear1", x)))
    return x + _stylization_eo(sd, f"{ffn}.proj_out", h, ffn_eo)


def _time_tokens(sd: StateDict, timesteps: torch.Tensor) -> torch.Tensor:
    """Sinusoid (width of time_embedding.linear_1's input) -> MLP."""
    freq_dim = sd["time_embedding.linear_1.weight"].shape[1]
    t_emb = sinusoidal_timestep_embedding(timesteps, freq_dim)
    return _lin(sd, "time_embedding.linear_2",
                F.silu(_lin(sd, "time_embedding.linear_1", t_emb)))


def _project_cond(sd: StateDict, cond: torch.Tensor) -> torch.Tensor:
    if "emb_proj.1.weight" in sd:
        return _lin(sd, "emb_proj.1", F.relu(cond))
    return cond


def denoiser_apply_pure(sd: StateDict, x: torch.Tensor, timesteps: torch.Tensor,
                        cond: torch.Tensor, num_layers: int = 5,
                        md_invariants: Dict | None = None) -> torch.Tensor:
    """Plain twin of `Denoiser.forward` for x (B, 1, D). md_invariants, from
    `md_step_invariants`, may carry the condition invariants; then cond is
    unused."""
    if x.shape[1] != 1:
        raise ValueError("denoiser_apply_pure covers the one-latent-token path")
    emb = _time_tokens(sd, timesteps)[:, None]
    inv = md_invariants
    if inv is None:
        inv = md_step_invariants(sd, _project_cond(sd, cond), num_layers)
    names = layer_names(num_layers)
    nb = (num_layers - 1) // 2
    h = x + sd["query_pos.pe"][:1, 0][None]
    skips = []
    for i, name in enumerate(names):
        if i > nb:
            j = i - nb - 1
            h = _lin(sd, f"encoder.linear_blocks.{j}", torch.cat([h, skips.pop()], dim=-1))
        h = _md_layer_t1(sd, name, h, inv[name], emb)
        if i < nb:
            skips.append(h)
    return _ln(sd, "encoder.norm", h)


def ddim_schedule_arrays(schedule, num_steps: int, device="cpu"):
    """(timesteps int64, acp_t f32, acp_prev f32), each (num_steps,)."""
    ts = schedule.ddim_timesteps(num_steps)
    acp = schedule.alphas_cumprod
    acp_prev = [schedule.alpha_prev(int(t), num_steps) for t in ts]
    return (torch.as_tensor(ts.copy(), device=device),
            torch.as_tensor(acp[ts], dtype=torch.float32, device=device),
            torch.as_tensor(acp_prev, dtype=torch.float32, device=device))


def ddim_fused_plain(sd: StateDict, cond: torch.Tensor, z_init: torch.Tensor,
                     schedule: DiffusionSchedule, num_steps: int, num_layers: int = 5,
                     guidance_scale: float = 1.0) -> torch.Tensor:
    """The `ddim_sample` loop over `denoiser_apply_pure`, with the condition
    invariants hoisted; cond is [uncond; cond] (2B rows) when
    guidance_scale > 1."""
    inv = md_step_invariants(sd, _project_cond(sd, cond), num_layers)
    return ddim_sample(
        lambda x, t: denoiser_apply_pure(sd, x, t, None, num_layers, md_invariants=inv),
        schedule, tuple(z_init.shape), num_steps, guidance_scale, z_init=z_init)


def _window_precompute(sd: StateDict, cond: torch.Tensor, timesteps: torch.Tensor):
    """The condition projection and every step's time token, once per window."""
    return _project_cond(sd, cond), _time_tokens(sd, timesteps)


class KernelWeights:
    """The denoiser's weights in the kernel's layout: every matrix as a fresh
    contiguous (in, out) f32 tensor, and a device table of their pointers in
    the order of the enum in `csrc/ddim_md.cu`."""

    PER_LAYER = 32

    @torch.no_grad()
    def __init__(self, sd: StateDict, num_layers: int):
        t = lambda x: x.detach().t().contiguous().clone()  # noqa: E731
        c = lambda x: x.detach().contiguous().clone()  # noqa: E731
        tensors = []
        for name in layer_names(num_layers):
            (wq, bq), (wk, bk), (wv, bv) = _qkv(sd, name)
            sa, ca, ffn = f"{name}.sa_block", f"{name}.ca_block", f"{name}.ffn"
            g = lambda n: sd[n]  # noqa: E731
            tensors += [
                t(wq), c(bq), t(wk), c(bk), t(wv), c(bv),
                t(g(f"{sa}.self_attn.out_proj.weight")), c(g(f"{sa}.self_attn.out_proj.bias")),
                c(g(f"{sa}.norm1.weight")), c(g(f"{sa}.norm1.bias")),
                t(g(f"{sa}.linear1.weight")), c(g(f"{sa}.linear1.bias")),
                t(g(f"{sa}.linear2.weight")), c(g(f"{sa}.linear2.bias")),
                c(g(f"{sa}.norm2.weight")), c(g(f"{sa}.norm2.bias")),
                c(g(f"{ca}.norm.weight")), c(g(f"{ca}.norm.bias")),
                t(g(f"{ca}.query.weight")), c(g(f"{ca}.query.bias")),
                c(g(f"{ca}.proj_out.norm.weight")), c(g(f"{ca}.proj_out.norm.bias")),
                t(g(f"{ca}.proj_out.out_layers.2.weight")),
                c(g(f"{ca}.proj_out.out_layers.2.bias")),
                t(g(f"{ffn}.linear1.weight")), c(g(f"{ffn}.linear1.bias")),
                t(g(f"{ffn}.linear2.weight")), c(g(f"{ffn}.linear2.bias")),
                c(g(f"{ffn}.proj_out.norm.weight")), c(g(f"{ffn}.proj_out.norm.bias")),
                t(g(f"{ffn}.proj_out.out_layers.2.weight")),
                c(g(f"{ffn}.proj_out.out_layers.2.bias")),
            ]
        for j in range((num_layers - 1) // 2):
            tensors += [t(sd[f"encoder.linear_blocks.{j}.weight"]),
                        c(sd[f"encoder.linear_blocks.{j}.bias"])]
        tensors += [c(sd["encoder.norm.weight"]), c(sd["encoder.norm.bias"]),
                    c(sd["query_pos.pe"][0, 0])]
        assert len(tensors) == num_layers * self.PER_LAYER + 2 * ((num_layers - 1) // 2) + 3
        self.tensors = tensors
        self.num_layers = num_layers
        self.d_model = sd["encoder.norm.weight"].shape[0]
        self.sa_ff = sd[f"{layer_names(num_layers)[0]}.sa_block.linear1.weight"].shape[0]
        self.ff = sd[f"{layer_names(num_layers)[0]}.ffn.linear1.weight"].shape[0]
        self.table = torch.tensor([x.data_ptr() for x in tensors], dtype=torch.int64,
                                  device=tensors[0].device)


def ddim_fused(sd: StateDict, cond: torch.Tensor, z_init: torch.Tensor,
               schedule: DiffusionSchedule, num_steps: int, num_layers: int = 5,
               guidance_scale: float = 1.0, weights: KernelWeights | None = None) -> torch.Tensor:
    """Whole DDIM reverse process (eps prediction, eta 0), as `ddim_sample`:
    z_init (B, 1, D) is unit noise, scaled by init_noise_sigma here; cond
    (B, NC, text_dim), or (2B, ...) as [uncond; cond] when guidance_scale > 1.
    Returns z (B, 1, D)."""
    if z_init.device.type == "cpu":
        return ddim_fused_plain(sd, cond, z_init, schedule, num_steps, num_layers,
                                guidance_scale)
    dev = z_init.device
    B, T, D = z_init.shape
    cfg = guidance_scale > 1.0
    if T != 1:
        raise ValueError("ddim_fused: the kernel covers one latent token")
    if cond.shape[0] != (2 * B if cfg else B):
        raise ValueError(f"ddim_fused: cond has {cond.shape[0]} rows for batch {B}"
                         f" at guidance {guidance_scale}")
    for name, x in (("z_init", z_init), ("cond", cond)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"ddim_fused: {name} must be contiguous float32 on {dev}")
    if weights is None:
        weights = KernelWeights(sd, num_layers)
    if weights.num_layers != num_layers or weights.d_model != D:
        raise ValueError("ddim_fused: kernel weights do not match the call")
    for n in (D, weights.sa_ff, weights.ff):
        if n < 4 or n % 4 or 512 % (n // 4):
            raise ValueError(f"ddim_fused: width {n} is not supported by the kernel")
    timesteps, acp_t, acp_prev = ddim_schedule_arrays(schedule, num_steps, dev)
    with torch.no_grad():
        cond_p, time_tokens = _window_precompute(sd, cond, timesteps)
        inv = md_step_invariants(sd, cond_p, num_layers, time_tokens)
        names = layer_names(num_layers)
        inv_cond = torch.stack([
            torch.stack([inv[n][k] for k in ("k_xf", "v_xf", "ca_key", "ca_value")], dim=2)
            for n in names]).contiguous()                               # (L, Bc, NC, 4, D)
        inv_step = torch.stack([
            torch.cat([inv[n][k] for k in ("k_emb", "v_emb", "ca_eo", "ffn_eo")], dim=-1)
            for n in names]).contiguous()                               # (L, steps, 6D)
    z0 = (z_init * schedule.init_noise_sigma).reshape(B, D).contiguous()
    z_out = torch.empty(B, D, device=dev)
    lib = _build.load_library()
    ddim_fused.launches += 1
    _build.check(lib.ddim_md_t1(
        z0.data_ptr(), z_out.data_ptr(), inv_cond.data_ptr(), inv_step.data_ptr(),
        weights.table.data_ptr(), acp_t.data_ptr(), acp_prev.data_ptr(),
        B, cond.shape[0], cond.shape[1], D, weights.sa_ff, weights.ff, num_layers, num_steps,
        float(guidance_scale), int(cfg), _build.stream_ptr(dev)), "ddim_md_t1")
    return z_out.reshape(B, 1, D)


ddim_fused.launches = 0
