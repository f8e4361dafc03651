"""Plain PyTorch maths of the measured paths: the benchmark's reference.

Written from the published model definitions (MLD's motion VAE and
denoisers, SEE-ME's MD stylization layers and PointNet scene encoder,
diffusers' DDIM, SMPL's joint regressor and kinematic chain, HumanML3D's
RIC recovery). It imports torch and numpy only: no kernel, no part of the
measured program. Every function reads a state dict under the reference
MLD checkpoint's key names and the inputs that the benchmark made.

Each product goes through `Arith`, which runs it in float32 or, for the
control, with both operands rounded to TF32 (10 mantissa bits, nearest,
ties away from zero, as `cvt.rna.tf32.f32` does) and a float32 sum: what a
TF32 tensor core computes. The emulation gives the same control on the card
and on the CPU.

Work that does not change over the reverse process is done once a window:
the condition tokens' projections, and each step's time token and its
projections, shared by every row. That is the algorithm whose operations
`portbench/counts.py` counts.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# SMPL's kinematic tree: the parent of joint k (joint 0, the pelvis, has none)
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                20, 21)
NEG_INF = -1e9
LN_EPS = 1e-5
AA_EPS = 1e-8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits, kept in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """The products of the reference, in float32 (`tf32=False`) or with
    TF32 operands (`tf32=True`, the control)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._r(a), self._r(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.mm(x, w.t())
        return y if b is None else y + b


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Ref:
    """A state dict read under its key names, with the products of `ar`;
    `heads` attention heads in the VAE's and the token-concat denoiser's
    layers."""

    def __init__(self, sd: StateDict, ar: Arith, heads: int = 1):
        self.sd, self.ar, self.heads = sd, ar, heads

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.ar.linear(x, self.sd[f"{name}.weight"], self.sd.get(f"{name}.bias"))

    def ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.sd[f"{name}.weight"], self.sd[f"{name}.bias"])

    def qkv(self, attn: str):
        w, b = self.sd[f"{attn}.in_proj_weight"], self.sd[f"{attn}.in_proj_bias"]
        return tuple(zip(w.chunk(3), b.chunk(3)))

    # ------------------------------------------------------ transformer layers
    def attention(self, attn: str, q_in, kv_in, key_valid=None) -> torch.Tensor:
        """Attention of `q_in` rows over `kv_in` rows in `heads` heads, each
        over its slice of the width, then out_proj."""
        (wq, bq), (wk, bk), (wv, bv) = self.qkv(attn)
        B, H = q_in.shape[0], self.heads

        def split(x):                                   # (B, S, D) -> (B, H, S, D / H)
            return x.reshape(B, x.shape[1], H, -1).transpose(1, 2)

        q = split(self.ar.linear(q_in, wq, bq))
        k = split(self.ar.linear(kv_in, wk, bk))
        v = split(self.ar.linear(kv_in, wv, bv))
        logits = self.ar.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if key_valid is not None:
            logits = logits + torch.where(key_valid, 0.0, NEG_INF)[:, None, None, :]
        out = self.ar.mm(torch.softmax(logits, -1), v).transpose(1, 2)
        return self.lin(f"{attn}.out_proj", out.reshape(*q_in.shape[:2], -1))

    def encoder_layer(self, name: str, x, key_valid=None, act=gelu) -> torch.Tensor:
        """Post-norm self-attention and feed-forward block."""
        x = self.ln(f"{name}.norm1", x + self.attention(f"{name}.self_attn", x, x, key_valid))
        h = self.lin(f"{name}.linear2", act(self.lin(f"{name}.linear1", x)))
        return self.ln(f"{name}.norm2", x + h)

    def decoder_layer(self, name: str, x, memory, key_valid=None) -> torch.Tensor:
        """Post-norm self-attention, cross-attention over `memory`, feed-forward."""
        x = self.ln(f"{name}.norm1", x + self.attention(f"{name}.self_attn", x, x, key_valid))
        x = self.ln(f"{name}.norm2", x + self.attention(f"{name}.multihead_attn", x, memory))
        h = self.lin(f"{name}.linear2", gelu(self.lin(f"{name}.linear1", x)))
        return self.ln(f"{name}.norm3", x + h)

    def uskip(self, prefix: str, x, num_layers: int, layer) -> torch.Tensor:
        """(L-1)/2 input blocks, the middle block, (L-1)/2 output blocks, each
        output block after a Linear over [x; the matching input block's
        output]; then the final LayerNorm."""
        nb = (num_layers - 1) // 2
        skips = []
        for i in range(nb):
            x = layer(f"{prefix}.input_blocks.{i}", x)
            skips.append(x)
        x = layer(f"{prefix}.middle_block", x)
        for i in range(nb):
            x = self.lin(f"{prefix}.linear_blocks.{i}", torch.cat([x, skips.pop()], -1))
            x = layer(f"{prefix}.output_blocks.{i}", x)
        return self.ln(f"{prefix}.norm", x)

    # -------------------------------------------------------------- motion VAE
    def vae_encode_mu(self, feats: torch.Tensor, num_layers: int) -> torch.Tensor:
        """(B, T, nfeats) -> mu (B, latent tokens, D): distribution tokens
        before the embedded frames, learned positions, the U-skip encoder."""
        B, T, _ = feats.shape
        tokens = self.sd["vae.global_motion_token"]
        n = tokens.shape[0] // 2
        x = torch.cat([tokens[None].expand(B, -1, -1), self.lin("vae.skel_embedding", feats)], 1)
        x = x + self.sd["vae.query_pos_encoder.pe"][: x.shape[1], 0]
        out = self.uskip("vae.encoder", x, num_layers, lambda nm, h: self.encoder_layer(nm, h))
        return out[:, :n]

    def vae_decode(self, z: torch.Tensor, nframes: int, num_layers: int,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, latent tokens, D) -> (B, nframes, nfeats): zero queries at
        learned positions through the U-skip decoder over the latent, frames
        past `lengths` masked as keys of its self-attention."""
        B, _, D = z.shape
        valid = None
        if lengths is not None:
            valid = torch.arange(nframes, device=z.device)[None] < lengths[:, None]
        q = z.new_zeros(B, nframes, D) + self.sd["vae.query_pos_decoder.pe"][:nframes, 0]
        out = self.uskip("vae.decoder", q, num_layers,
                         lambda nm, h: self.decoder_layer(nm, h, z, valid))
        return self.lin("vae.final_layer", out)

    # ---------------------------------------------------------------- denoiser
    def time_token(self, t: int, freq_dim: int, device) -> torch.Tensor:
        """(1, D) embedded timestep: diffusers' sinusoid (cos first), MLP."""
        half = freq_dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=device) / half)
        arg = float(t) * freqs
        emb = torch.cat([torch.cos(arg), torch.sin(arg)])[None]
        h = silu(self.lin("denoiser.time_embedding.linear_1", emb))
        return self.lin("denoiser.time_embedding.linear_2", h)

    def project_cond(self, cond: torch.Tensor) -> torch.Tensor:
        if "denoiser.emb_proj.1.weight" in self.sd:
            return self.lin("denoiser.emb_proj.1", torch.relu(cond))
        return cond

    def md_window(self, xf: torch.Tensor, num_layers: int) -> Dict[str, Dict]:
        """Each MD layer's work on the condition tokens xf (B, N, D), which
        does not change over the steps: their keys and values for the
        self-attention, the cross-attention's key (softmaxed over the tokens)
        and value."""
        out = {}
        for name in uskip_layers("denoiser.encoder", num_layers):
            (_, _), (wk, bk), (wv, bv) = self.qkv(f"{name}.sa_block.self_attn")
            ca = f"{name}.ca_block"
            xfn = self.ln(f"{ca}.text_norm", xf)
            out[name] = {"k": self.ar.linear(xf, wk, bk), "v": self.ar.linear(xf, wv, bv),
                         "ca_key": torch.softmax(self.lin(f"{ca}.key", xfn), dim=1),
                         "ca_value": self.lin(f"{ca}.value", xfn)}
        return out

    def stylize(self, prefix: str, h: torch.Tensor, eo: torch.Tensor) -> torch.Tensor:
        scale, shift = eo[:, None, :].chunk(2, dim=-1)
        h = self.ln(f"{prefix}.norm", h) * (1 + scale) + shift
        return self.lin(f"{prefix}.out_layers.2", silu(h))

    def md_layer(self, name: str, x: torch.Tensor, win: Dict, emb: torch.Tensor):
        """One MD layer for x (B, T, D), time token emb (1, D): the latent
        rows attend to [latent rows; condition tokens; time token] (post-norm,
        ReLU feed-forward), then the linear cross-attention over the
        condition tokens, then the stylized GELU feed-forward."""
        B, T, D = x.shape
        sa, ca, ffn = f"{name}.sa_block", f"{name}.ca_block", f"{name}.ffn"
        (wq, bq), (wk, bk), (wv, bv) = self.qkv(f"{sa}.self_attn")
        se = silu(emb)
        q = self.ar.linear(x, wq, bq)
        keys = torch.cat([self.ar.linear(x, wk, bk), win["k"],
                          self.ar.linear(emb, wk, bk)[None].expand(B, -1, -1)], 1)
        values = torch.cat([self.ar.linear(x, wv, bv), win["v"],
                            self.ar.linear(emb, wv, bv)[None].expand(B, -1, -1)], 1)
        attn = torch.softmax(self.ar.mm(q, keys.transpose(1, 2)) / math.sqrt(D), -1)
        x = self.ln(f"{sa}.norm1", x + self.lin(f"{sa}.self_attn.out_proj",
                                                 self.ar.mm(attn, values)))
        x = self.ln(f"{sa}.norm2", x + self.lin(f"{sa}.linear2",
                                                 torch.relu(self.lin(f"{sa}.linear1", x))))
        query = torch.softmax(self.lin(f"{ca}.query", self.ln(f"{ca}.norm", x)), dim=-1)
        y = self.ar.mm(self.ar.mm(query, win["ca_key"].transpose(1, 2)), win["ca_value"])
        x = x + self.stylize(f"{ca}.proj_out", y, self.lin(f"{ca}.proj_out.emb_layers.1", se))
        h = self.lin(f"{ffn}.linear2", gelu(self.lin(f"{ffn}.linear1", x)))
        return x + self.stylize(f"{ffn}.proj_out", h,
                                self.lin(f"{ffn}.proj_out.emb_layers.1", se))

    def md_denoise(self, x: torch.Tensor, win: Dict, emb: torch.Tensor,
                   num_layers: int) -> torch.Tensor:
        x = x + self.sd["denoiser.query_pos.pe"][: x.shape[1], 0]
        return self.uskip("denoiser.encoder", x, num_layers,
                          lambda nm, h: self.md_layer(nm, h, win[nm], emb))

    def tok_denoise(self, x: torch.Tensor, cond_p: torch.Tensor, emb: torch.Tensor,
                    num_layers: int) -> torch.Tensor:
        """The token-concat stack: post-norm GELU layers over [latent rows;
        time token; condition tokens] at learned positions; the latent rows
        out."""
        B, T, _ = x.shape
        seq = torch.cat([x, emb[None].expand(B, -1, -1), cond_p], 1)
        seq = seq + self.sd["denoiser.query_pos.pe"][: seq.shape[1], 0]
        out = self.uskip("denoiser.encoder", seq, num_layers,
                         lambda nm, h: self.encoder_layer(nm, h))
        return out[:, :T]


def uskip_layers(prefix: str, num_layers: int) -> Sequence[str]:
    """A U-skip stack's layers in execution order: input blocks, middle,
    output blocks."""
    nb = (num_layers - 1) // 2
    return ([f"{prefix}.input_blocks.{i}" for i in range(nb)] + [f"{prefix}.middle_block"]
            + [f"{prefix}.output_blocks.{i}" for i in range(nb)])


# ------------------------------------------------------------------ schedule
class Schedule:
    """diffusers' DDIM schedule: betas in float64, cumulative alphas kept in
    float32, 'leading' inference timesteps with `steps_offset`, the
    previous alpha of the first training step when `set_alpha_to_one` is
    false."""

    def __init__(self, num_train_timesteps: int, beta_start: float, beta_end: float,
                 beta_schedule: str, set_alpha_to_one: bool, steps_offset: int,
                 clip_sample: bool = False):
        if beta_schedule != "scaled_linear" or clip_sample:
            raise ValueError(f"beta schedule {beta_schedule!r} (clip_sample {clip_sample}) "
                             "is not scaled_linear without clipping")
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
        self.acp = np.cumprod(1.0 - betas).astype(np.float32)
        self.n_train = num_train_timesteps
        self.one = set_alpha_to_one
        self.offset = steps_offset

    def timesteps(self, steps: int):
        ratio = self.n_train // steps
        return [int(t) + self.offset for t in (np.arange(steps) * ratio).round()[::-1]]

    def alphas(self, t: int, steps: int):
        prev = t - self.n_train // steps
        a_prev = self.acp[prev] if prev >= 0 else (1.0 if self.one else self.acp[0])
        return float(self.acp[t]), float(a_prev)


def ddim(schedule: Schedule, steps: int, z: torch.Tensor, denoise, guidance: float):
    """Eta-0 DDIM with epsilon prediction; `denoise(x, t)` runs the
    [uncond; cond] doubled batch when guidance > 1."""
    for t in schedule.timesteps(steps):
        if guidance > 1.0:
            uncond, cond = denoise(torch.cat([z, z]), t).chunk(2)
            eps = uncond + guidance * (cond - uncond)
        else:
            eps = denoise(z, t)
        a_t, a_prev = schedule.alphas(t, steps)
        a_t = torch.tensor(a_t, dtype=torch.float32, device=z.device)
        a_prev = torch.tensor(a_prev, dtype=torch.float32, device=z.device)
        x0 = (z - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        z = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    return z


# ---------------------------------------------------------------- PointNet
def pointnet(ref: Ref, prefix: str, points: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """(B, N, 3) -> (B, out): fc_pos, a ResNet-FC block, three blocks over
    [x; max over the points], each Linear over the concatenation taken as
    its two halves, then fc_c over the ReLU of the max; `chunk` clouds at a
    time."""
    outs = []
    for pts in points.split(chunk):
        h = ref.lin(f"{prefix}.fc_pos_0", pts)
        b0 = f"{prefix}.block_0"
        net = ref.lin(f"{b0}.fc_0", torch.relu(h))
        x = ref.lin(f"{b0}.shortcut", h) + ref.lin(f"{b0}.fc_1", torch.relu(net))
        H = x.shape[-1]
        for i in (1, 2, 3):
            blk = f"{prefix}.block_{i}"
            w0, ws = ref.sd[f"{blk}.fc_0.weight"], ref.sd[f"{blk}.shortcut.weight"]
            pooled = x.amax(dim=1, keepdim=True)
            net = (ref.ar.linear(torch.relu(x), w0[:, :H])
                   + ref.ar.linear(torch.relu(pooled), w0[:, H:], ref.sd[f"{blk}.fc_0.bias"]))
            x = (ref.ar.linear(x, ws[:, :H]) + ref.ar.linear(pooled, ws[:, H:])
                 + ref.lin(f"{blk}.fc_1", torch.relu(net)))
        outs.append(ref.lin(f"{prefix}.fc_c", torch.relu(x.amax(dim=1))))
    return torch.cat(outs)


# -------------------------------------------------------------------- SMPL
def aa_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> wxyz unit quaternion, the epsilon inside the norm."""
    angle = torch.sqrt(((aa + AA_EPS) ** 2).sum(-1, keepdim=True))
    return torch.cat([torch.cos(angle * 0.5), torch.sin(angle * 0.5) * aa / angle], -1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.sqrt((q ** 2).sum(-1, keepdim=True))
    w, x, y, z = q.unbind(-1)
    rows = [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
            2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z]
    return torch.stack(rows, -1).reshape(*q.shape[:-1], 3, 3)


def smpl_joints(ar: Arith, body: Dict[str, torch.Tensor], betas: torch.Tensor,
                pose_aa: torch.Tensor, transl: torch.Tensor) -> torch.Tensor:
    """SMPL's 24 posed joints, no skinning: n bodies of shape `betas` (n,
    10), axis-angle `pose_aa` (n, 24, 3) (global orientation first),
    translation (n, 3)."""
    J = body["j_regressor"]
    j_template = ar.mm(J, body["v_template"])                                   # (24, 3)
    V = J.shape[1]
    j_dirs = ar.mm(J, body["shapedirs"].reshape(V, -1)).reshape(24, 3, -1)      # (24, 3, 10)
    rest = j_template + ar.mm(betas, j_dirs.reshape(72, -1).t()).reshape(-1, 24, 3)
    R = quat_to_rotmat(aa_to_quat(pose_aa))                                     # (n, 24, 3, 3)
    n = rest.shape[0]
    bottom = R.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 1, 4)
    world = []
    for k in range(24):
        parent = SMPL_PARENTS[k]
        offset = rest[:, k] - (rest[:, parent] if parent >= 0 else 0.0)
        local = torch.cat([torch.cat([R[:, k], offset[:, :, None]], -1), bottom], 1)
        world.append(local if parent < 0 else ar.mm(world[parent], local))
    return torch.stack([w[:, :3, 3] for w in world], 1) + transl[:, None, :]


# --------------------------------------------------------------------- RIC
def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v)
    return v + 2 * (q[..., :1] * uv + torch.linalg.cross(u, uv))


def ric_joints(raw: torch.Tensor, njoints: int) -> torch.Tensor:
    """HumanML3D's recovery of joint positions from (..., T, D) RIC
    features: the root's yaw and planar position integrated over the
    frames, the local joint positions rotated by the inverse yaw and
    offset by the root."""
    rot_vel = raw[..., 0]
    ang = torch.cumsum(torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], -1), -1)
    zero = torch.zeros_like(ang)
    q_inv = torch.stack([torch.cos(ang), zero, -torch.sin(ang), zero], -1)
    vel = torch.cat([torch.zeros_like(raw[..., :1, 1:3]), raw[..., :-1, 1:3]], -2)
    step = torch.stack([vel[..., 0], torch.zeros_like(vel[..., 0]), vel[..., 1]], -1)
    pos = torch.cumsum(qrot(q_inv, step), -2)
    root = torch.stack([pos[..., 0], raw[..., 3], pos[..., 2]], -1)
    local = raw[..., 4: (njoints - 1) * 3 + 4].reshape(*raw.shape[:-1], njoints - 1, 3)
    local = qrot(q_inv[..., None, :].expand(*local.shape[:-1], 4), local)
    offset = torch.stack([root[..., 0], torch.zeros_like(root[..., 0]), root[..., 2]], -1)
    return torch.cat([root[..., None, :], local + offset[..., None, :]], -2)
