"""Plain reference of `mld-humanml3d` (MLD's text-to-motion model on
HumanML3D): the eta-0 DDIM reverse process over the token-concat denoiser
conditioned on the caption embedding, with classifier-free guidance over
[zero embedding; caption] rows above guidance 1, the VAE decode with frames
past each length masked as keys, and the RIC joint recovery in float64. Plain PyTorch
over the benchmark's own weights and statistics (`plain.py`)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import plain

# the widest gap each compared number may show, max |program - reference|
# / max |reference| over the run's sampled batches and valid frames;
# PERF.md gives the readings each was set from
LIMITS = {"latent": 6e-4, "feats": 7e-4, "joints": 1.2e-2}


def _model(conf: Dict) -> Dict:
    return conf["config"]["model"]


def sample(ar: plain.Arith, weights, conf: Dict, text_emb: torch.Tensor,
           lengths: torch.Tensor, z_init: torch.Tensor):
    """(latents (B, 1, D), decoded features (B, max_len, nfeats))."""
    m = _model(conf)
    L, steps = m["num_layers"], m["scheduler"]["num_inference_timesteps"]
    ref = plain.Ref(weights, ar, heads=int(m["num_head"]))
    cond = text_emb[:, None, :]
    if m["guidance_scale"] > 1.0:
        cond = torch.cat([torch.zeros_like(cond), cond])
    cond_p = ref.project_cond(cond)
    freq = weights["denoiser.time_embedding.linear_1.weight"].shape[1]
    z = plain.ddim(plain.Schedule(**m["scheduler"]["params"]), steps, z_init,
                   lambda x, t: ref.tok_denoise(x, cond_p, ref.time_token(t, freq, x.device), L),
                   m["guidance_scale"])
    T = int(conf["config"]["DATASET"]["SAMPLER"]["MAX_LEN"])
    return z, ref.vae_decode(z, T, L, lengths)


def joints(conf: Dict, mean, std, feats: torch.Tensor) -> torch.Tensor:
    """(B, T, 22, 3) joints recovered in float64 from normalized features,
    returned in float32."""
    raw = feats.double() * std.double() + mean.double()
    return plain.ric_joints(raw, conf["njoints"]).float()
