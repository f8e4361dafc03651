"""EgoHMR (`seeme_tpu_torch/models/egohmr.py::EgoHmr`) over the benchmark's
synthetic SMPL body, built as `seeme_tpu_torch/test_egohmr.py::main` builds it
(`EgoHmrConfig` from the configuration's `model` keys, which at the published
widths is `EgoHmrConfig()`; the betas head's width, the schedule and the
prediction, which the model fixes, are checked), with the rot6d statistics
`body_rep_mean` / `body_rep_std` made from the seed (`rot6d_stats`) and
scaled to the model's predictions (`scale_spreads`).

`redraw` mends what `systems.make_weights` draws wrongly for this model. That
function reads every 1-D tensor as a bias or a norm scale, and a tensor's
fan-in as the product of all its dimensions after the first. Here that gives
the batch norms' running variances (parameters of `FrozenBatchNorm2d`)
negative values, so the ResNet50 and the GCN return NaN; each graph conv's
`W` (2, in, out) a standard deviation of 1 / sqrt(in x out), 32 times too
small at width 1024, so the GCN's products barely touch its output; the
per-joint modulation `M` (24, out) values near 0.03 where it scales each
output; and the learned adjacency offset `adj2` (24, 24), a small correction
to the skeleton's adjacency (1e-6 at initialisation), a standard deviation
of 0.2, which joins every pair of joints. A graph conv's output sums two
products over `in` features (the joint's own and its neighbours' mean), so
its fan-in rule gives `W` 1 / sqrt(2 x in). With 1 / sqrt(in) and the wide
`adj2` each step's prediction grows with the state it is given, and the 50
steps drive the state to 1e13-1e19, where the rot6d normalization's squares
overflow float32; with these draws its final RMS is 10-250. `systems.build`
draws the weights after `make` returns, so the route
(`routes/egohmr_crops.py`) calls `redraw` on what `build` gives, then
`scale_spreads` with the RMS of the reference's final prediction.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.systems import Built, generator, make_body

# the `EgoHmrConfig` fields a configuration's `model` gives
FIELDS = ("img_feat_dim", "scene_feat_dim", "transl_embed_dim", "input_process_dim",
          "timestep_embed_dim", "gcn_hid_dim", "gcn_layers", "only_mask_img_cond",
          "with_focal_length", "with_bbox_info", "with_cam_center", "fx_norm_coeff",
          "num_train_timesteps", "timestep_respacing")
# the identity rotation's 6D in the 'diffusion' layout: its first two columns, row-major
REST_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def make(conf: Dict, tree, seed: int, device):
    from seeme_tpu_torch.core.smpl import SmplModel
    from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig

    model = conf["config"]["model"]
    fixed = {"betas_hidden": 1024, "beta_schedule": "cosine", "prediction": "x0"}
    if any(model[k] != v for k, v in fixed.items()):
        raise ValueError(f"EgoHmr has {fixed}, the configuration asks for "
                         f"{ {k: model[k] for k in fixed} }")
    cfg = EgoHmrConfig(**{k: model[k] for k in FIELDS})
    body = make_body(seed, device, conf["smpl_vertices"], conf["smpl_betas"])
    smpl = SmplModel(v_template=body["v_template"], shapedirs=body["shapedirs"],
                     posedirs=body["posedirs"], j_regressor=body["j_regressor"],
                     lbs_weights=body["lbs_weights"], parents=body["parents"])
    system = EgoHmr(cfg, smpl, device=device)
    mean, std = rot6d_stats(seed, int(model["latent_dim"][0]) // 6, device)
    system.body_rep_mean.copy_(mean)
    system.body_rep_std.copy_(std)
    return system, body, mean, std


@torch.no_grad()
def rot6d_stats(seed: int, joints: int, device):
    """Each joint's rot6d mean and std, (6 x joints,) each, as a dataset of
    human poses gives them for a unit-scale prediction: about the rest pose
    (the identity's 6D plus 0.02 N(0, 1)), spreads 0.1 + 0.1 U(0, 1). The
    benchmark's generic statistics centre them on 0, where the 6D decoding of
    a random model's prediction is ill-conditioned: a rounding of 1e-5 in the
    pose then moved the joints by up to 2e-3 of their scale on the card."""
    g = generator(seed, "stats", device)
    mean = torch.tensor(REST_6D, device=device).repeat(joints)
    mean = mean + 0.02 * torch.randn(6 * joints, generator=g, device=device)
    return mean, 0.1 + 0.1 * torch.rand(6 * joints, generator=g, device=device)


@torch.no_grad()
def scale_spreads(built: Built, rms: torch.Tensor) -> None:
    """The spreads divided by `rms`, the RMS of the model's normalized
    prediction, which for random weights is far from a trained model's 1, in
    `built.std` and in the program's `body_rep_std`."""
    built.std = built.std / rms
    built.system.body_rep_std.copy_(built.std)


@torch.no_grad()
def redraw(built: Built, seed: int) -> None:
    """From the seed, in `built.weights` and in the program's copy: every
    batch norm's `running_var` 0.5 + U(0, 1); each graph conv's `W[k]` of
    standard deviation 1 / sqrt(2 x in), each `M` 1 + 0.1 N(0, 1) and each
    `adj2` 0.01 N(0, 1)."""
    weights = built.weights
    names = sorted(n for n in weights if n.endswith(("running_var", ".W", ".M", ".adj2")))
    device = weights[names[0]].device
    g = generator(seed, "weights.redraw", device)
    for n in names:
        shape = weights[n].shape
        if n.endswith("running_var"):
            weights[n] = 0.5 + torch.rand(shape, generator=g, device=device)
        elif n.endswith(".W"):
            weights[n] = torch.randn(shape, generator=g, device=device) / math.sqrt(2 * shape[1])
        elif n.endswith(".M"):
            weights[n] = 1.0 + 0.1 * torch.randn(shape, generator=g, device=device)
        else:
            weights[n] = 0.01 * torch.randn(shape, generator=g, device=device)
    built.system.load_state_dict({n: weights[n] for n in names}, strict=False)
