"""Plain reference of `egohmr-egobody`: EgoHMR (Zhang, Ma, Sun and Tang,
*Probabilistic Human Mesh Recovery in 3D Scenes from Egocentric Views*, ICCV
2023), its test path as SEE-ME vendors it (`EgoHMR/models/egohmr/egohmr.py`,
`test_egohmr.py`). Plain PyTorch over the benchmark's own weights, body and
statistics, written from the model's equations:

* encode: a ResNet50 (torchvision's bottleneck layout, batch norm as the
  affine map of its running statistics, eps 1e-5) over the NHWC crop to 2048
  features; the scene's ResNet-PointNet at hidden width 256 (`plain.pointnet`)
  to 512; the translation MLP (3 -> 64 -> 128, ReLU); the camera block
  [cx / f, cy / f, box centre / f, box size / f, fx] with f = fx x
  `fx_norm_coeff`, each part under its `with_*` switch;
* per joint, [image features x the joint's visibility | scene | translation |
  camera]; visibility from the OpenPose-25 confidences (> 0), the pelvis
  always visible; the scene-only rows have the image block zeroed;
* the denoiser: the noisy rot6d embedded per joint (6 -> 512), the timestep's
  row of the sinusoidal table (sin on even, cos on odd columns, built in
  float32 on the host as the published `PositionalEncoding` builds it)
  through Linear-SiLU-Linear, and a modulated GCN over SMPL's kinematic
  tree: each graph conv h0 = x W0, h1 = x W1, A = sym(adj + adj2), out =
  (A o I)(M o h0) + (A o (1 - I))(M o h1) + b, with adj the tree's
  adjacency, row-normalised without self-loops, identity on the diagonal;
  an input block, residual blocks of two, each conv then batch norm and ReLU,
  and an output conv to 6 a joint, predicting x0;
* the reverse process: the cosine schedule over the training steps (betas
  from alpha_bar, at most 0.999), respaced `ddimN` (the stride that gives N
  steps), ancestral DDPM steps with the fixed-small variance, each step's
  two predictions fused by visibility (visible joints the conditioned one);
  then a final prediction at t = 0;
* the mesh: the prediction renormalised, each joint's 6 numbers read as a 3 x
  2 matrix whose two columns are Gram-Schmidt'd to the rotation's first two
  columns (EgoHMR's 'diffusion' layout, `utils/geometry.py`), the third
  their cross product; betas from the unmasked features (context -> 1024 ->
  10); SMPL with shape and pose blend shapes, the kinematic chain and linear
  blend skinning to every vertex.

Departures: the initial betas and the dataset's rot6d statistics are the
benchmark's (zero betas; mean and std from the seed); the schedule's
coefficients are computed in float64 and applied in float32; work shared by
every row of a step (the timestep's embedding, the noisy rot6d's embedding,
shared by the two branches) is done once. Each product goes through
`plain.Arith` (convolutions too), so the control computes them with TF32
operands.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import plain

# the widest gap each compared number may show, max |program - reference|
# / max |reference| over the run's sampled batches, each set near the
# geometric middle between the program's largest reading on the card (29
# runs: 16 calibration seeds, 13 windows) and the TF32 control's smallest (4
# seeds), 6-13x from each (PERF.md gives them):
LIMITS = {
    # program 1.3e-5 (the PointNet's split-bf16 products), control 6.4e-4
    "feats": 1e-4,
    # program 1.5e-5 after 51 GCN passes, control 1.3e-3
    "pose": 1e-4,
    # program 3.2e-5 (the rot6d decoding and the chain carry the pose's
    # gap), control 1.5e-3
    "joints": 2e-4,
    # program 2.7e-5, control 1.5e-3
    "vertices": 2e-4,
}

JOINTS = 24
PELVIS = 8                      # OpenPose-25's mid-hip
# the OpenPose-25 joint whose confidence gives each SMPL joint's visibility
OPENPOSE_TO_SMPL = (8, 12, 9, 8, 13, 10, 8, 14, 11, 8, 14, 11, 0, 5, 2, 0, 5, 2, 6, 3, 7, 4,
                    7, 4)
BN_EPS = 1e-5
RESNET50 = (3, 4, 6, 3)


def _model(conf: Dict) -> Dict:
    return conf["config"]["model"]


# --------------------------------------------------------------------- encode
def conv(ar: plain.Arith, x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    if ar.tf32:
        x, w = plain.tf32_round(x), plain.tf32_round(w)
    return F.conv2d(x, w, None, stride, padding)


def batch_norm(sd, name: str, x: torch.Tensor) -> torch.Tensor:
    """Running-statistics batch norm over dimension 1 (or the last, for the
    GCN's (rows, joints, channels)) as its affine map."""
    scale = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + BN_EPS)
    shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * scale
    if x.ndim == 4:
        return x * scale[:, None, None] + shift[:, None, None]
    return x * scale + shift


def resnet50(ar: plain.Arith, sd, img: torch.Tensor, prefix: str = "backbone") -> torch.Tensor:
    """(B, H, W, 3) -> (B, 2048): conv 7x7/2, max-pool 3x3/2, four bottleneck
    stages (the stride on each stage's first 3x3), global average pool."""
    x = img.permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(sd, f"{prefix}.bn1", conv(ar, x, sd[f"{prefix}.conv1.weight"], 2, 3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage, blocks in enumerate(RESNET50):
        for b in range(blocks):
            n = f"{prefix}.layer{stage + 1}.{b}"
            stride = 2 if stage > 0 and b == 0 else 1
            out = torch.relu(batch_norm(sd, f"{n}.bn1", conv(ar, x, sd[f"{n}.conv1.weight"])))
            out = torch.relu(batch_norm(sd, f"{n}.bn2",
                                        conv(ar, out, sd[f"{n}.conv2.weight"], stride, 1)))
            out = batch_norm(sd, f"{n}.bn3", conv(ar, out, sd[f"{n}.conv3.weight"]))
            if b == 0:
                x = batch_norm(sd, f"{n}.downsample.1",
                               conv(ar, x, sd[f"{n}.downsample.0.weight"], stride))
            x = torch.relu(out + x)
    return x.mean(dim=(2, 3))


def camera(m: Dict, batch: Dict) -> torch.Tensor:
    f = batch["fx"] * m["fx_norm_coeff"]
    parts = []
    if m["with_cam_center"]:
        parts += [batch["cam_cx"] / f, batch["cam_cy"] / f]
    if m["with_bbox_info"]:
        parts += [batch["box_center"][:, 0] / f, batch["box_center"][:, 1] / f,
                  batch["box_size"] / f]
    if m["with_focal_length"]:
        parts.append(batch["fx"])
    return torch.stack(parts, dim=-1)


def encode(ar: plain.Arith, weights, conf: Dict, batch: Dict) -> torch.Tensor:
    """(B, 2048 + 646): [image | scene | translation | camera] features."""
    ref = plain.Ref(weights, ar)
    transl = batch["smpl_params"]["transl"]
    return torch.cat([resnet50(ar, weights, batch["img"]),
                      plain.pointnet(ref, "scene_enc", batch["scene_pcd"]),
                      ref.lin("transl_enc.layers.2",
                              torch.relu(ref.lin("transl_enc.layers.0", transl))),
                      camera(_model(conf), batch)], dim=-1)


def visibility(batch: Dict) -> torch.Tensor:
    """(B, 24) bool: each SMPL joint's OpenPose confidence above 0, the
    pelvis always."""
    vis = batch["orig_keypoints_2d"][:, :, -1] > 0
    vis[:, PELVIS] = True
    return vis[:, list(OPENPOSE_TO_SMPL)]


# ------------------------------------------------------------------- denoiser
def adjacency(device) -> torch.Tensor:
    """SMPL's tree, symmetric, each row divided by its degree, then the
    identity on the diagonal."""
    A = np.zeros((JOINTS, JOINTS), np.float64)
    for child, parent in enumerate(plain.SMPL_PARENTS):
        if parent >= 0:
            A[parent, child] = A[child, parent] = 1.0
    A = A / A.sum(1, keepdims=True) + np.eye(JOINTS)
    return torch.as_tensor(A.astype(np.float32), device=device)


def timestep_row(t: int, width: int, device) -> torch.Tensor:
    """(1, width): row t of the sinusoidal table."""
    div = torch.exp(torch.arange(0, width, 2, dtype=torch.float32) * (-math.log(10000.0) / width))
    arg = torch.tensor([float(t)]) * div
    row = torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1).reshape(1, width)
    return row.to(device)


def graph_conv(ar: plain.Arith, sd, name: str, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """(R, 24, in) -> (R, 24, out): the modulated graph convolution."""
    W, M = sd[f"{name}.W"], sd[f"{name}.M"]
    A = adj + sd[f"{name}.adj2"]
    A = (A + A.t()) / 2
    eye = torch.eye(JOINTS, device=x.device)
    h0, h1 = ar.mm(x, W[0]), ar.mm(x, W[1])
    return ar.mm(A * eye, M * h0) + ar.mm(A * (1 - eye), M * h1) + sd[f"{name}.bias"]


def gcn(ar: plain.Arith, sd, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """The modulated GCN: input block, residual blocks, output conv."""
    def block(name, h):
        return torch.relu(batch_norm(sd, f"{name}.bn", graph_conv(ar, sd, f"{name}.gconv", h, adj)))

    p = "diffusion_model"
    x = block(f"{p}.gconv_input.0", x)
    layers = sum(1 for k in sd if k.startswith(f"{p}.gconv_layers.")
                 and k.endswith("gconv1.gconv.W"))
    for i in range(layers):
        n = f"{p}.gconv_layers.{i}"
        x = x + block(f"{n}.gconv2", block(f"{n}.gconv1", x))
    return graph_conv(ar, sd, f"{p}.gconv_output", x, adj)


def denoise(ar: plain.Arith, sd, cond2: torch.Tensor, x: torch.Tensor, t: int,
            adj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's two x0 predictions, (B, 144) each: the GCN over the
    stacked [conditioned; scene-only] rows `cond2` (2B, 24, context), the
    noisy rot6d x (B, 144) embedded once for both, the timestep's embedding
    once for every row."""
    ref = plain.Ref(sd, ar)
    B = x.shape[0]
    emb = ref.lin("input_process.poseEmbedding", x.reshape(B, JOINTS, 6))
    width = sd["embed_timestep.time_embed.0.weight"].shape[1]
    row = timestep_row(t, width, x.device)
    t_emb = ref.lin("embed_timestep.time_embed.2",
                    plain.silu(ref.lin("embed_timestep.time_embed.0", row)))
    inp = torch.cat([cond2, torch.cat([emb, emb]),
                     t_emb.expand(2 * B, JOINTS, -1)], dim=-1)
    return gcn(ar, sd, inp, adj).reshape(2 * B, JOINTS * 6).chunk(2)


# ------------------------------------------------------------------- schedule
def schedule(conf: Dict) -> Tuple[List[int], np.ndarray]:
    """(each respaced step's model timestep, the respaced steps' cumulative
    alphas in float32): the cosine schedule over `num_train_timesteps`,
    respaced `ddimN`."""
    m = _model(conf)
    T, spacing = int(m["num_train_timesteps"]), m["timestep_respacing"]
    if not spacing.startswith("ddim"):
        raise ValueError(f"respacing {spacing!r} is not ddimN")
    n = int(spacing[len("ddim"):])
    stride = next(i for i in range(1, T) if len(range(0, T, i)) == n)
    s = np.arange(T + 1, dtype=np.float64) / T
    alpha_bar = np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2
    betas = np.minimum(1 - alpha_bar[1:] / alpha_bar[:-1], 0.999)
    acp = np.cumprod(1.0 - betas).astype(np.float32)
    used = list(range(0, T, stride))
    return used, acp[used]


def ddpm_step(acp: np.ndarray, k: int, x0: torch.Tensor, x: torch.Tensor,
              noise) -> torch.Tensor:
    """x_k -> x_{k-1} of the respaced chain with the fixed-small variance; no
    noise at k = 0."""
    a_t = float(acp[k])
    a_prev = float(acp[k - 1]) if k > 0 else 1.0
    beta = 1.0 - a_t / a_prev
    mean = (math.sqrt(a_prev) * beta / (1.0 - a_t)) * x0 \
        + (math.sqrt(1.0 - beta) * (1.0 - a_prev) / (1.0 - a_t)) * x
    if k == 0:
        return mean
    return mean + math.sqrt(max((1.0 - a_prev) / (1.0 - a_t) * beta, 1e-20)) * noise


def sample(ar: plain.Arith, weights, conf: Dict, batch: Dict, feats: torch.Tensor,
           draws: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B, 144): the normalized rot6d of the final prediction at t = 0, after
    the reverse process from draws[0] with draws[1:] as the steps' noise."""
    m = _model(conf)
    img_dim = int(m["img_feat_dim"])
    vis = visibility(batch)
    cond = torch.cat([feats[:, None, :img_dim] * vis[..., None],
                      feats[:, None, img_dim:].expand(-1, JOINTS, -1)], dim=-1)
    if m["only_mask_img_cond"]:
        uncond = torch.cat([torch.zeros_like(cond[..., :img_dim]), cond[..., img_dim:]], -1)
    else:
        uncond = torch.zeros_like(cond)
    cond2 = torch.cat([cond, uncond])
    vis6 = vis.repeat_interleave(6, dim=-1)
    adj = adjacency(feats.device)
    used, acp = schedule(conf)

    def fused(x, t):
        pred, pred_scene = denoise(ar, weights, cond2, x, t, adj)
        return torch.where(vis6, pred, pred_scene)

    x = draws[0]
    for i, k in enumerate(range(len(used) - 1, -1, -1)):
        x = ddpm_step(acp, k, fused(x, used[k]), x, draws[i + 1] if k > 0 else None)
    return fused(x, 0)


# ----------------------------------------------------------------------- mesh
def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) as a 3 x 2 matrix, row-major: its two columns Gram-Schmidt'd
    to the rotation's first two columns, the third their cross product."""
    m = x.reshape(*x.shape[:-1], 3, 2)
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.norm(a2, dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def smpl(ar: plain.Arith, body: Dict, betas: torch.Tensor,
         R: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMPL's 24 posed joints (B, 24, 3) and vertices (B, V, 3) from betas
    (B, 10) and local rotations R (B, 24, 3, 3), no translation."""
    B, V = betas.shape[0], body["v_template"].shape[0]
    v_shaped = body["v_template"] + ar.mm(betas, body["shapedirs"].reshape(V * 3, -1).t()
                                          ).reshape(B, V, 3)
    J = ar.mm(body["j_regressor"], v_shaped)                                    # (B, 24, 3)
    eye = torch.eye(3, device=R.device)
    v_posed = v_shaped + ar.mm((R[:, 1:] - eye).reshape(B, -1),
                               body["posedirs"]).reshape(B, V, 3)
    bottom = R.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, 1, 4)
    world = []
    for k, parent in enumerate(plain.SMPL_PARENTS):
        offset = J[:, k] - (J[:, parent] if parent >= 0 else 0.0)
        local = torch.cat([torch.cat([R[:, k], offset[:, :, None]], -1), bottom], 1)
        world.append(local if parent < 0 else ar.mm(world[parent], local))
    G = torch.stack(world, 1)                                                   # (B, 24, 4, 4)
    joints = G[..., :3, 3]
    # each joint's transform relative to its rest position
    rel = torch.cat([G[..., :3, :3], (joints - ar.mm(G[..., :3, :3], J[..., None])[..., 0])
                     [..., None]], -1)                                          # (B, 24, 3, 4)
    T = ar.mm(body["lbs_weights"], rel.reshape(B, JOINTS, 12)).reshape(B, V, 3, 4)
    verts = ar.mm(T[..., :3], v_posed[..., None])[..., 0] + T[..., 3]
    return joints, verts


def mesh(ar: plain.Arith, weights, body: Dict, mean: torch.Tensor, std: torch.Tensor,
         feats: torch.Tensor, pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The predicted SMPL joints (B, 24, 3) and vertices (B, V, 3)."""
    ref = plain.Ref(weights, ar)
    B = pose.shape[0]
    R = rot6d_to_rotmat((pose * std + mean).reshape(B, JOINTS, 6))
    betas = ref.lin("beta_layer.layers.2", torch.relu(ref.lin("beta_layer.layers.0", feats)))
    return smpl(ar, body, betas, R)
