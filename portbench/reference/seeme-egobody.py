"""Plain reference of `seeme-egobody` (SEE-ME on EgoBody): the condition
tokens (the interactee's VAE mean, the PointNet scene token through its
ReLU-Linear projection), the eta-0 DDIM reverse process over the MD
stylization denoiser, the VAE decode, and SMPL joints of the prediction, of
the wearer's ground truth and of the interactee. Plain PyTorch over the
benchmark's own weights, body and statistics (`plain.py`)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import plain

# the widest gap each compared number may show, max |program - reference|
# / max |reference| over the run's sampled batches; PERF.md gives the
# readings each was set from
LIMITS = {"cond": 1.5e-4, "latent": 3e-4, "feats": 3e-4, "joints": 5e-4}

WEARER, INTERACTEE = 0, 1


def _model(conf: Dict) -> Dict:
    return conf["config"]["model"]


def schedule(conf: Dict) -> plain.Schedule:
    return plain.Schedule(**_model(conf)["scheduler"]["params"])


def actor_features(batch: Dict, actor: int) -> torch.Tensor:
    """(B, T, 75): the actor's 72 pose features and its translation."""
    return torch.cat([batch["feats"][:, :, actor], batch["transl"][:, actor]], -1)


def encode(ar: plain.Arith, weights, conf: Dict, batch: Dict) -> torch.Tensor:
    """(B, 2, D) condition tokens [interactee; scene] (doubled as [uncond;
    cond] from zeroed inputs under guidance)."""
    m = _model(conf)
    ref = plain.Ref(weights, ar, heads=int(m["num_head"]))

    def tokens(b):
        mu = ref.vae_encode_mu(actor_features(b, INTERACTEE), m["num_layers"])
        scene = plain.pointnet(ref, "proscene.scene_enc", b["scene"])
        return torch.cat([mu, ref.lin("output_scene.1", torch.relu(scene))[:, None]], 1)

    cond = tokens(batch)
    if m["guidance_scale"] > 1.0:
        zeroed = {k: torch.zeros_like(v) if k in ("feats", "transl", "scene") else v
                  for k, v in batch.items()}
        cond = torch.cat([tokens(zeroed), cond])
    return cond


def sample(ar: plain.Arith, weights, conf: Dict, cond: torch.Tensor, z_init: torch.Tensor):
    """(latents (B, 1, D), decoded features (B, T, 75))."""
    m = _model(conf)
    L, steps = m["num_layers"], m["scheduler"]["num_inference_timesteps"]
    ref = plain.Ref(weights, ar, heads=int(m["num_head"]))
    win = ref.md_window(ref.project_cond(cond), L)
    freq = weights["denoiser.time_embedding.linear_1.weight"].shape[1]
    z = plain.ddim(schedule(conf), steps, z_init,
                   lambda x, t: ref.md_denoise(x, win, ref.time_token(t, freq, x.device), L),
                   m["guidance_scale"])
    return z, ref.vae_decode(z, int(conf["config"]["MOTION_LENGTH"]), L)


def joints(ar: plain.Arith, body, mean, std, batch: Dict, feats: torch.Tensor) -> torch.Tensor:
    """(3, B, T, 24, 3): SMPL joints of the prediction, of the wearer's
    ground truth and of the interactee, from renormalized features (global
    orientation, 23 joints' axis-angle, translation)."""
    B, T, n = feats.shape
    mean, std = mean[:n], std[:n]

    def fk(raw, actor):
        betas = batch["betas"][:, actor].reshape(B * T, -1)
        pose = raw[..., :72].reshape(B * T, 24, 3)
        return plain.smpl_joints(ar, body, betas, pose, raw[..., -3:].reshape(B * T, 3))

    out = [fk(feats * std + mean, WEARER),
           fk(actor_features(batch, WEARER) * std + mean, WEARER),
           fk(actor_features(batch, INTERACTEE) * std + mean, INTERACTEE)]
    return torch.stack(out).reshape(3, B, T, 24, 3)
