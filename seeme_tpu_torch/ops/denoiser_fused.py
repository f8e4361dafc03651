"""The DDIM reverse process in one CUDA launch (`seeme_tpu/ops/denoiser_fused.py`).

* `denoiser_apply_pure(sd, x, timesteps, cond)`: a plain twin of
  `models.denoiser.Denoiser` for T latent tokens, reading the denoiser's
  state dict. md_trans=True: the MD stylization stack, with the
  step-invariant condition projections hoisted (`md_step_invariants`); one
  latent token takes the T=1 layer (`_md_layer_t1`), more the general one
  (`_md_layer`), as the JAX twin branches. md_trans=False: the plain
  post-norm GELU stack over [x; time; cond], keeping the first T rows,
  its attention in `num_heads` heads (the JAX twin's is one head at any
  count).
* `ddim_fused_plain`: `diffusion/sampling.py::ddim_sample` (eta 0,
  epsilon prediction, CFG mix) over `denoiser_apply_pure`, for either block
  type, with the per-window precompute of the kernels.
* `ddim_fused` and `ddim_fused_grid` (md_trans=True) launch
  `csrc/ddim_md.cu`; `ddim_fused_tok` (md_trans=False) launches
  `csrc/ddim_tok.cu`, for any number T of latent tokens (each kernel's T = 1
  specialisation at one token, its general instance past it). Each runs all
  steps, all layers, the CFG mix and the
  DDIM update in one kernel launched as clusters of `CLUSTER_CTAS` CTAs that
  split every weight matrix by columns (`csrc/ddim_common.cuh`; a width
  that does not split is refused; the token kernel splits a feed-forward
  wider than the latent by depth), after the per-window precompute
  (`_window_precompute`: condition projection and every step's time token,
  plus `md_step_invariants` for the MD stack) in PyTorch, as the JAX
  package's `ddim_fused_grid` does in XLA. The TPU's grid variant differs
  from its loop variant only in where that precompute runs, so both MD
  entries share one CUDA kernel; each counts its own launches
  (`.launches`, and by latent token count in `.launches_by_tokens`). For
  CPU tensors they run `ddim_fused_plain`; on the card what a kernel cannot
  take raises, naming the limit.

GELU is the exact erf form throughout, as in the flax `Denoiser`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..diffusion.sampling import ddim_sample
from ..diffusion.schedulers import DiffusionSchedule
from ..nn.embeddings import sinusoidal_timestep_embedding
from ..utils.profiling import count, span
from . import _build

StateDict = Dict[str, torch.Tensor]


def _lin(sd: StateDict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"))


def _ln(sd: StateDict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def _qkv(sd: StateDict, attn: str):
    """(w, b) pairs of the q, k, v projections of an attention module."""
    w = sd[f"{attn}.in_proj_weight"]
    b = sd[f"{attn}.in_proj_bias"]
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
        (_, _), (wk, bk), (wv, bv) = _qkv(sd, f"{name}.sa_block.self_attn")
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
    x (B, 1, D); emb (B, 1, D) or (1, 1, D), one time token for every row,
    is the time token: its projections are then made once, as the kernel
    makes them once a step."""
    (wq, bq), (wk, bk), (wv, bv) = _qkv(sd, f"{name}.sa_block.self_attn")
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


def _md_layer(sd: StateDict, name: str, x: torch.Tensor, inv: Dict,
              emb: torch.Tensor) -> torch.Tensor:
    """One MD layer for T latent tokens (`denoiser_fused.py:284-318`). x (B,
    T, D); emb (B, 1, D) or (1, 1, D) is the time token. Each latent row attends to the T
    latent rows of its sample, the condition tokens (their k/v hoisted in
    `inv`) and the time token; the condition and time rows' own outputs are
    never kept, so they are not computed. The linear cross-attention mixes
    the condition values by <softmaxed query, softmaxed key>, not normalised
    over the tokens."""
    (wq, bq), (wk, bk), (wv, bv) = _qkv(sd, f"{name}.sa_block.self_attn")
    D = x.shape[-1]
    se = F.silu(emb[:, 0])
    ca_eo = _lin(sd, f"{name}.ca_block.proj_out.emb_layers.1", se)
    ffn_eo = _lin(sd, f"{name}.ffn.proj_out.emb_layers.1", se)

    q = F.linear(x, wq, bq)
    rows = (x.shape[0], -1, -1)
    keys = torch.cat([F.linear(x, wk, bk), inv["k_xf"], F.linear(emb, wk, bk).expand(rows)], dim=1)
    values = torch.cat([F.linear(x, wv, bv), inv["v_xf"], F.linear(emb, wv, bv).expand(rows)],
                       dim=1)
    attn = torch.softmax(q @ keys.transpose(1, 2) / math.sqrt(D), dim=-1)
    sa = f"{name}.sa_block"
    x = _ln(sd, f"{sa}.norm1", x + _lin(sd, f"{sa}.self_attn.out_proj", attn @ values))
    h = _lin(sd, f"{sa}.linear2", F.relu(_lin(sd, f"{sa}.linear1", x)))
    x = _ln(sd, f"{sa}.norm2", x + h)

    ca = f"{name}.ca_block"
    query = torch.softmax(_lin(sd, f"{ca}.query", _ln(sd, f"{ca}.norm", x)), dim=-1)
    y = (query @ inv["ca_key"].transpose(1, 2)) @ inv["ca_value"]   # (B, T, D)
    x = x + _stylization_eo(sd, f"{ca}.proj_out", y, ca_eo)

    ffn = f"{name}.ffn"
    h = _lin(sd, f"{ffn}.linear2", F.gelu(_lin(sd, f"{ffn}.linear1", x)))
    return x + _stylization_eo(sd, f"{ffn}.proj_out", h, ffn_eo)


def _encoder_layer(sd: StateDict, name: str, x: torch.Tensor,
                   num_heads: int = 1) -> torch.Tensor:
    """Post-norm GELU encoder layer over each sample's tokens (B, S, D),
    attention within the sample in `num_heads` heads, each over its slice of
    the width (`denoiser_fused.py:94-146` at one head;
    `nn/transformer.py::MultiHeadAttention`)."""
    (wq, bq), (wk, bk), (wv, bv) = _qkv(sd, f"{name}.self_attn")
    B, S, D = x.shape
    heads = lambda t: t.view(B, S, num_heads, D // num_heads).transpose(1, 2)  # noqa: E731
    q, k, v = (heads(F.linear(x, w, b)) for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // num_heads), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(B, S, D)
    x = _ln(sd, f"{name}.norm1", x + _lin(sd, f"{name}.self_attn.out_proj", out))
    h = _lin(sd, f"{name}.linear2", F.gelu(_lin(sd, f"{name}.linear1", x)))
    return _ln(sd, f"{name}.norm2", x + h)


def _uskip(sd: StateDict, h: torch.Tensor, num_layers: int, layer) -> torch.Tensor:
    """The U-skip stack: input blocks, middle, output blocks each after a
    skip_linear over [h; popped skip], then the final LayerNorm."""
    nb = (num_layers - 1) // 2
    skips = []
    for i, name in enumerate(layer_names(num_layers)):
        if i > nb:
            h = _lin(sd, f"encoder.linear_blocks.{i - nb - 1}", torch.cat([h, skips.pop()], dim=-1))
        h = layer(name, h)
        if i < nb:
            skips.append(h)
    return _ln(sd, "encoder.norm", h)


def _time_tokens(sd: StateDict, timesteps: torch.Tensor) -> torch.Tensor:
    """Sinusoid (width of time_embedding.linear_1's input: the text width
    when emb_proj exists) -> MLP."""
    freq_dim = sd["time_embedding.linear_1.weight"].shape[1]
    t_emb = sinusoidal_timestep_embedding(timesteps, freq_dim)
    return _lin(sd, "time_embedding.linear_2",
                F.silu(_lin(sd, "time_embedding.linear_1", t_emb)))


def _project_cond(sd: StateDict, cond: torch.Tensor) -> torch.Tensor:
    if "emb_proj.1.weight" in sd:
        return _lin(sd, "emb_proj.1", F.relu(cond))
    return cond


def denoiser_apply_pure(sd: StateDict, x: torch.Tensor, timesteps: torch.Tensor | None,
                        cond: torch.Tensor | None, num_layers: int = 5, md_trans: bool = True,
                        md_invariants: Dict | None = None,
                        time_token: torch.Tensor | None = None,
                        num_heads: int = 1) -> torch.Tensor:
    """Plain twin of `Denoiser.forward` for x (B, T, D). md_invariants, from
    `md_step_invariants`, may carry the MD stack's condition invariants; then
    cond is unused. time_token (B, 1, D), or (1, 1, D) for every row, the
    embedded time token, replaces the timestep MLP; then timesteps is unused.
    num_heads: the token-concat stack's attention heads (the MD stack's
    plain twin is one head, as kernel 3)."""
    T = x.shape[1]
    emb = time_token if time_token is not None else _time_tokens(sd, timesteps)[:, None]
    pe = sd["query_pos.pe"][:, 0]
    if not md_trans:
        xseq = torch.cat([x, emb.expand(x.shape[0], -1, -1), _project_cond(sd, cond)], dim=1)
        h = xseq + pe[: xseq.shape[1]][None]
        return _uskip(sd, h, num_layers,
                      lambda name, h: _encoder_layer(sd, name, h, num_heads))[:, :T]
    inv = md_invariants
    if inv is None:
        inv = md_step_invariants(sd, _project_cond(sd, cond), num_layers)
    layer = _md_layer_t1 if T == 1 else _md_layer
    return _uskip(sd, x + pe[:T][None], num_layers,
                  lambda name, h: layer(sd, name, h, inv[name], emb))


def ddim_schedule_arrays(schedule, num_steps: int, device="cpu"):
    """(timesteps int64, acp_t f32, acp_prev f32), each (num_steps,): three
    copies from the host, each of which waits for the card's stream."""
    count("host_sync.ddim_schedule", 3)
    ts = schedule.ddim_timesteps(num_steps)
    acp = schedule.alphas_cumprod
    acp_prev = [schedule.alpha_prev(int(t), num_steps) for t in ts]
    return (torch.as_tensor(ts.copy(), device=device),
            torch.as_tensor(acp[ts], dtype=torch.float32, device=device),
            torch.as_tensor(acp_prev, dtype=torch.float32, device=device))


def ddim_fused_plain(sd: StateDict, cond: torch.Tensor, z_init: torch.Tensor,
                     schedule: DiffusionSchedule, num_steps: int, num_layers: int = 5,
                     guidance_scale: float = 1.0, md_trans: bool = True,
                     num_heads: int = 1) -> torch.Tensor:
    """The `ddim_sample` loop over `denoiser_apply_pure`, with the kernels'
    per-window precompute (every step's time token; the condition
    projection; the MD stack's condition invariants) and, as the kernels
    make them, the time token's own projections once a step; cond is
    [uncond; cond] (2B rows) when guidance_scale > 1; num_heads as
    `denoiser_apply_pure`'s."""
    with span("sample.precompute"):
        timesteps = ddim_schedule_arrays(schedule, num_steps, z_init.device)[0]
        cond_p, time_tokens = _window_precompute(sd, cond, timesteps)
        tokens = dict(zip(timesteps.tolist(), time_tokens))
        inv = md_step_invariants(sd, cond_p, num_layers) if md_trans else None
    # the token stack takes the projected condition: without emb_proj in
    # its weights, `_project_cond` passes it through
    sd_steps = {k: v for k, v in sd.items() if not k.startswith("emb_proj.")}

    def denoiser(x, t):
        token = tokens[int(t[0])].view(1, 1, -1)
        return denoiser_apply_pure(sd_steps, x, None, cond_p, num_layers, md_trans, inv, token,
                                   num_heads)

    return ddim_sample(denoiser, schedule, tuple(z_init.shape), num_steps, guidance_scale,
                       z_init=z_init)


def _window_precompute(sd: StateDict, cond: torch.Tensor, timesteps: torch.Tensor):
    """The condition projection and every step's time token, once per window."""
    return _project_cond(sd, cond), _time_tokens(sd, timesteps)


class KernelWeights:
    """The denoiser's weights in a kernel's layout: every matrix as a fresh
    contiguous (in, out) f32 tensor, and a device table of their pointers in
    the order of the enum in `csrc/ddim_md.cuh` (md_trans=True, 32 per layer)
    or `csrc/ddim_tok.cuh` (md_trans=False, its first 16, per layer), then the
    skip_linears, the final norm and query_pos row 0; and the head count the
    token kernel's attention takes (the MD kernel's is one head)."""

    @torch.no_grad()
    def __init__(self, sd: StateDict, num_layers: int, md_trans: bool = True,
                 num_heads: int = 1):
        t = lambda x: x.detach().t().contiguous().clone()  # noqa: E731
        c = lambda x: x.detach().contiguous().clone()  # noqa: E731

        def encoder_layer(p):
            (wq, bq), (wk, bk), (wv, bv) = _qkv(sd, f"{p}.self_attn")
            return [t(wq), c(bq), t(wk), c(bk), t(wv), c(bv),
                    t(sd[f"{p}.self_attn.out_proj.weight"]), c(sd[f"{p}.self_attn.out_proj.bias"]),
                    c(sd[f"{p}.norm1.weight"]), c(sd[f"{p}.norm1.bias"]),
                    t(sd[f"{p}.linear1.weight"]), c(sd[f"{p}.linear1.bias"]),
                    t(sd[f"{p}.linear2.weight"]), c(sd[f"{p}.linear2.bias"]),
                    c(sd[f"{p}.norm2.weight"]), c(sd[f"{p}.norm2.bias"])]

        tensors = []
        for name in layer_names(num_layers):
            if not md_trans:
                tensors += encoder_layer(name)
                continue
            ca, ffn = f"{name}.ca_block", f"{name}.ffn"
            g = lambda n: sd[n]  # noqa: E731
            tensors += encoder_layer(f"{name}.sa_block") + [
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
        per_layer = 32 if md_trans else 16
        assert len(tensors) == num_layers * per_layer + 2 * ((num_layers - 1) // 2) + 3
        self.tensors = tensors
        self.num_layers = num_layers
        self.md_trans = md_trans
        self.num_heads = num_heads
        self.d_model = sd["encoder.norm.weight"].shape[0]
        first = layer_names(num_layers)[0]
        # FFN widths: an MD layer's sa_block ReLU FFN and stylized GELU FFN;
        # a plain layer's one GELU FFN
        self.sa_ff = sd[f"{first}.sa_block.linear1.weight" if md_trans
                        else f"{first}.linear1.weight"].shape[0]
        self.ff = sd[f"{first}.ffn.linear1.weight"].shape[0] if md_trans else self.sa_ff
        self.table = torch.tensor([x.data_ptr() for x in tensors], dtype=torch.int64,
                                  device=tensors[0].device)


def _check_call(name: str, sd: StateDict, cond: torch.Tensor, z_init: torch.Tensor,
                num_layers: int, guidance_scale: float, weights: KernelWeights | None,
                md_trans: bool, num_heads: int = 1) -> KernelWeights:
    """Raise on any input the kernels do not take; return the weights (built
    here at num_heads when none are given)."""
    B, T, D = z_init.shape
    if cond.dim() != 3 or cond.shape[0] != (2 * B if guidance_scale > 1.0 else B):
        raise ValueError(f"{name}: cond of shape {tuple(cond.shape)} for batch {B}"
                         f" at guidance {guidance_scale}")
    for arg, x in (("z_init", z_init), ("cond", cond)):
        if x.device != z_init.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous float32 on {z_init.device}")
    if weights is None:
        weights = KernelWeights(sd, num_layers, md_trans, num_heads)
    if (weights.num_layers != num_layers or weights.d_model != D
            or weights.md_trans != md_trans or weights.tensors[0].device != z_init.device):
        raise ValueError(f"{name}: kernel weights do not match the call")
    return weights


CLUSTER_CTAS = 8  # CTAs per cluster of both DDIM kernels (CLUSTER in csrc/ddim_common.cuh)


def _check_split(name: str, n: int) -> None:
    """Raise unless width n splits over the cluster as the kernels need
    (`splits` in csrc/ddim_common.cuh): as an output, n / CLUSTER_CTAS
    columns a CTA in whole float4 quads whose count divides a warp; as the
    next product's depth, whole blocks of 4 rows for each of up to 16 warps."""
    quads = n // (4 * CLUSTER_CTAS)
    if n <= 0 or n % 64 or 32 % quads:
        raise ValueError(f"{name}: width {n} does not split into {CLUSTER_CTAS} column "
                         f"slices of whole float4 quads")


def cluster_launch(md_trans: bool, batch: int, n_cond: int, weights: KernelWeights,
                   guidance_scale: float, tokens: int = 1) -> Dict[str, int]:
    """The cluster launch `ddim_fused` (md_trans) or `ddim_fused_tok` makes
    for these shapes, asked of the CUDA runtime without launching: CTAs per
    cluster, CTAs in the grid, clusters that fit on the card at once,
    dynamic shared memory bytes per CTA, and samples a cluster carries."""
    lib = _build.load_library()
    cfg = int(guidance_scale > 1.0)
    info = (ctypes.c_int * 5)()
    if md_trans:
        err = lib.ddim_md_info(batch, tokens, n_cond, weights.d_model, weights.sa_ff, weights.ff,
                               weights.num_layers, cfg, info)
    else:
        err = lib.ddim_tok_info(batch, tokens, n_cond, weights.ff, weights.num_layers,
                                weights.num_heads, cfg, info)
    _build.check(err, "ddim_md_info" if md_trans else "ddim_tok_info")
    return dict(zip(("cluster", "grid", "active_clusters", "smem_bytes", "samples"), info))


def _tokens(T: int, NC: int, cfg: int) -> str:
    return f"{T} latent and {NC} condition tokens{' under CFG' if cfg else ''}"


def _count(wrapper, T: int) -> None:
    wrapper.launches += 1
    wrapper.launches_by_tokens[T] = wrapper.launches_by_tokens.get(T, 0) + 1


def _launch_ddim_md(wrapper, sd, cond, z_init, schedule, num_steps, num_layers,
                    guidance_scale, weights):
    """Run `csrc/ddim_md.cu` (MD stack, T latent tokens) after the per-window
    precompute, counting the launch on `wrapper`."""
    name = wrapper.__name__
    weights = _check_call(name, sd, cond, z_init, num_layers, guidance_scale, weights, True)
    dev = z_init.device
    B, T, D = z_init.shape
    if D != 256:
        raise ValueError(f"{name}: latent width {D} is not 256")
    for n in (weights.sa_ff, weights.ff):
        _check_split(name, n)
    cfg = int(guidance_scale > 1.0)
    lib = _build.load_library()
    with torch.no_grad(), span("sample.precompute"):
        timesteps, acp_t, acp_prev = ddim_schedule_arrays(schedule, num_steps, dev)
        cond_p, time_tokens = _window_precompute(sd, cond, timesteps)
        inv = md_step_invariants(sd, cond_p, num_layers, time_tokens)
        names = layer_names(num_layers)
        inv_cond = torch.stack([
            torch.stack([inv[n][k] for k in ("k_xf", "v_xf", "ca_key", "ca_value")], dim=2)
            for n in names]).contiguous()                               # (L, Bc, NC, 4, D)
        inv_step = torch.stack([
            torch.cat([inv[n][k] for k in ("k_emb", "v_emb", "ca_eo", "ffn_eo")], dim=-1)
            for n in names]).contiguous()                               # (L, steps, 6D)
        z0 = (z_init * schedule.init_noise_sigma).reshape(B, T * D).contiguous()
        z_out = torch.empty(B, T * D, device=dev)
        pe = sd["query_pos.pe"][:T, 0].contiguous()
    with span("sample.denoise"):
        _build.check(lib.ddim_md(
            z0.data_ptr(), z_out.data_ptr(), inv_cond.data_ptr(), inv_step.data_ptr(),
            weights.table.data_ptr(), acp_t.data_ptr(), acp_prev.data_ptr(), pe.data_ptr(),
            B, cond.shape[0], cond.shape[1], D, weights.sa_ff, weights.ff, num_layers,
            num_steps, T, float(guidance_scale), cfg, _build.stream_ptr(dev)), name,
            _tokens(T, cond.shape[1], cfg))
    _count(wrapper, T)
    return z_out.reshape(B, T, D)


def ddim_fused(sd: StateDict, cond: torch.Tensor, z_init: torch.Tensor,
               schedule: DiffusionSchedule, num_steps: int, num_layers: int = 5,
               guidance_scale: float = 1.0, weights: KernelWeights | None = None) -> torch.Tensor:
    """Whole DDIM reverse process (eps prediction, eta 0) over the MD stack,
    as `ddim_sample`: z_init (B, T, D) is unit noise, scaled by
    init_noise_sigma here; cond (B, NC, text_dim), or (2B, ...) as
    [uncond; cond] when guidance_scale > 1. Returns z (B, T, D)."""
    if z_init.device.type == "cpu":
        return ddim_fused_plain(sd, cond, z_init, schedule, num_steps, num_layers,
                                guidance_scale)
    return _launch_ddim_md(ddim_fused, sd, cond, z_init, schedule, num_steps, num_layers,
                           guidance_scale, weights)


ddim_fused.launches = 0
ddim_fused.launches_by_tokens = {}


def ddim_fused_grid(sd: StateDict, cond: torch.Tensor, z_init: torch.Tensor,
                    schedule: DiffusionSchedule, num_steps: int, num_layers: int = 5,
                    guidance_scale: float = 1.0,
                    weights: KernelWeights | None = None) -> torch.Tensor:
    """`ddim_fused` under the name of the JAX package's grid variant
    (`SeeMeConfig.fused_variant="grid"`), which differs from the loop
    variant only in running the per-window precompute outside its kernel,
    as the port always does: it launches the same `csrc/ddim_md.cu` kernel
    and counts its launches in `ddim_fused_grid.launches`."""
    if z_init.device.type == "cpu":
        return ddim_fused_plain(sd, cond, z_init, schedule, num_steps, num_layers,
                                guidance_scale)
    return _launch_ddim_md(ddim_fused_grid, sd, cond, z_init, schedule, num_steps,
                           num_layers, guidance_scale, weights)


ddim_fused_grid.launches = 0
ddim_fused_grid.launches_by_tokens = {}

TOK_MAX_COND = 8  # condition tokens the token kernel takes, as the JAX fused route


def ddim_fused_tok(sd: StateDict, cond: torch.Tensor, z_init: torch.Tensor,
                   schedule: DiffusionSchedule, num_steps: int, num_layers: int = 5,
                   guidance_scale: float = 1.0, weights: KernelWeights | None = None,
                   num_heads: int = 1) -> torch.Tensor:
    """Whole DDIM reverse process over the plain token-concat stack
    (md_trans=False, the JAX package's `ddim_fused(md_trans=False)`, here
    with the model's `num_heads`): as `ddim_fused`, with cond (B or 2B, NC
    <= 8, text_dim); the kernel refuses more than 30 token rows a sample (T
    + 1 + NC, twice that under CFG) and heads narrower than 32 columns or
    not dividing 256; `_check_split` caps the feed-forward at 1024. The head
    count is the weights'; num_heads only builds weights when none are
    given. Launches `csrc/ddim_tok.cu` for CUDA tensors, counted in
    `ddim_fused_tok.launches`."""
    if weights is not None:
        num_heads = weights.num_heads
    if z_init.device.type == "cpu":
        return ddim_fused_plain(sd, cond, z_init, schedule, num_steps, num_layers,
                                guidance_scale, md_trans=False, num_heads=num_heads)
    weights = _check_call("ddim_fused_tok", sd, cond, z_init, num_layers, guidance_scale,
                          weights, False, num_heads)
    dev = z_init.device
    B, T, D = z_init.shape
    NC = cond.shape[1]
    cfg = int(guidance_scale > 1.0)
    if not 1 <= NC <= TOK_MAX_COND:
        raise ValueError(f"ddim_fused_tok: {NC} condition tokens; the kernel takes 1 to "
                         f"{TOK_MAX_COND}")
    if D != 256:
        raise ValueError(f"ddim_fused_tok: latent width {D} is not 256")
    _check_split("ddim_fused_tok", weights.ff)
    lib = _build.load_library()
    with torch.no_grad(), span("sample.precompute"):
        timesteps, acp_t, acp_prev = ddim_schedule_arrays(schedule, num_steps, dev)
        cond_p, time_tokens = _window_precompute(sd, cond, timesteps)
        pe = sd["query_pos.pe"][: T + 1 + NC, 0]
        cond_in = (cond_p + pe[T + 1:]).contiguous()       # (Bc, NC, D), positions T+1..
        time_in = (time_tokens + pe[T]).contiguous()        # (steps, D), position T
        z0 = (z_init * schedule.init_noise_sigma).reshape(B, T * D).contiguous()
        z_out = torch.empty(B, T * D, device=dev)
        pe_lat = pe[:T].contiguous()
    with span("sample.denoise"):
        _build.check(lib.ddim_tok(
            z0.data_ptr(), z_out.data_ptr(), cond_in.data_ptr(), time_in.data_ptr(),
            weights.table.data_ptr(), acp_t.data_ptr(), acp_prev.data_ptr(), pe_lat.data_ptr(),
            B, NC, weights.ff, num_layers, weights.num_heads, num_steps, T, float(guidance_scale),
            cfg, _build.stream_ptr(dev)), "ddim_fused_tok", _tokens(T, NC, cfg))
    _count(ddim_fused_tok, T)
    return z_out.reshape(B, T, D)


ddim_fused_tok.launches = 0
ddim_fused_tok.launches_by_tokens = {}
