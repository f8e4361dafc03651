"""Joints -> SMPL parameter fitting (`fit.py` at the repo root, the SMPLify
role of the reference's `fit.py` + `joints2rots/smplify.py`).

    python -m seeme_tpu_torch.fit --joints FILE.npy [--out fitted_smpl.npz]
        [--steps 300] [--gmm DIR_OR_PKL] [--save_mesh FILE.npy] [--smpl_path PKL]
        [--device cpu | --cpu]

Given a (T, J >= 24, 3) joint sequence, Adam (lr 0.02) over global_orient,
body_pose, shared betas and transl (from the target pelvis) fits the body's
`smpl_joints24` to the joints, with the root script's losses
(`fit.py:25-47`): the squared joint distance, the pose prior
(`core/pose_prior.py::MaxMixturePrior`, the standard-normal fallback without
`--gmm`'s file), the angle prior on elbows and knees, and the betas prior.
`torch.optim.Adam` takes `optax.adam`'s step (epsilon outside the square
root, both moments bias-corrected). It writes the parameters to `--out` and,
with `--save_mesh`, the fitted vertices and `<name>_faces.npy`. The body is
the SMPL file at `--smpl_path` when it exists, else the synthetic SMPL model
(`synthetic_smpl(6890)`), as the root script reads it (`fit.py:113-119`).
It runs on the card unless `--device cpu` (or `--cpu`) is given, and raises
when there is no card.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import full_float32, resolve_device
from .core.pose_prior import MaxMixturePrior
from .core.smpl import SmplModel, smpl_body, smpl_forward, smpl_joints24

# knees and elbows bend one way: exp of the wrong-sign angle is penalized
# (the reference's pose indices [55-3, 58-3, 12-3, 15-3] of the 69-d body pose)
ANGLE_PRIOR_IDX = [52, 55, 9, 12]
ANGLE_PRIOR_SIGN = [-1.0, 1.0, -1.0, -1.0]


def smplify_losses(joints_pred, joints_target, body_pose, betas, w_joints=1.0, w_pose=1e-3,
                   w_angle=1e-2, w_betas=1e-3, pose_prior=None) -> Tuple[torch.Tensor, Dict]:
    """(total, terms) of `fit.py::smplify_losses`."""
    loss_joints = ((joints_pred - joints_target) ** 2).sum(-1).mean()
    loss_pose = pose_prior(body_pose).mean() if pose_prior is not None else (body_pose ** 2).mean()
    sign = torch.as_tensor(ANGLE_PRIOR_SIGN, dtype=body_pose.dtype, device=body_pose.device)
    loss_angle = (torch.exp(body_pose[..., ANGLE_PRIOR_IDX] * sign) ** 2).mean()
    loss_betas = (betas ** 2).mean()
    total = w_joints * loss_joints + w_pose * loss_pose + w_angle * loss_angle + w_betas * loss_betas
    return total, {"joints": loss_joints, "pose": loss_pose, "angle": loss_angle,
                   "betas": loss_betas}


def fit_smpl_to_joints(smpl: SmplModel, joints_target: torch.Tensor, num_steps: int = 300,
                       lr: float = 0.02, shared_betas: bool = True, pose_prior=None,
                       history: Optional[list] = None) -> Tuple[Dict, Dict]:
    """(fitted parameters, the last step's loss terms) of `fit.py::fit_smpl_to_joints`,
    in the dtype and on the device of `joints_target` (N, 24, 3); `history`
    collects every step's total loss."""
    N = joints_target.shape[0]
    kw = dict(dtype=joints_target.dtype, device=joints_target.device)
    params = {"global_orient": torch.zeros(N, 3, **kw), "body_pose": torch.zeros(N, 69, **kw),
              "betas": torch.zeros(1 if shared_betas else N, 10, **kw),
              "transl": joints_target[:, 0].detach().clone()}  # from the target pelvis
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    terms: Dict = {}
    for _ in range(num_steps):
        betas = params["betas"].expand(N, 10)
        joints = smpl_joints24(smpl, betas, params["body_pose"], params["global_orient"],
                               params["transl"])
        loss, terms = smplify_losses(joints, joints_target, params["body_pose"], betas,
                                     pose_prior=pose_prior)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if history is not None:
            history.append(float(loss.detach()))
    return ({k: v.detach() for k, v in params.items()},
            {k: float(v.detach()) for k, v in terms.items()})


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.fit")
    ap.add_argument("--joints", required=True, help="(T, J>=24, 3) npy file")
    ap.add_argument("--smpl_path", default="./deps/smpl_models/smpl/SMPL_NEUTRAL.pkl")
    ap.add_argument("--out", default="fitted_smpl.npz")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--gmm", default="./deps/joints2rots/smpl_prior",
                    help="dir or pkl of the MaxMixturePrior GMM (gmm_08.pkl); "
                         "standard-normal fallback when absent")
    ap.add_argument("--save_mesh", default=None, help="also write a (T, V, 3) vertex npy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Fit; returns {"params", "terms", "losses"} (every step's total loss)."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    full_float32()
    smpl = smpl_body(args.smpl_path if os.path.exists(args.smpl_path) else "", dev)
    prior = MaxMixturePrior(args.gmm)
    if prior.is_fallback:
        print("no GMM asset — standard-normal pose prior")
    joints = torch.as_tensor(np.load(args.joints), dtype=torch.float32, device=dev)[:, :24]
    losses: list = []
    params, terms = fit_smpl_to_joints(smpl, joints, num_steps=args.steps, pose_prior=prior,
                                       history=losses)
    np.savez(args.out, **{k: v.cpu().numpy() for k, v in params.items()})
    print(f"fitted {joints.shape[0]} frames -> {args.out}; final terms: {terms}")
    if args.save_mesh:
        N = params["body_pose"].shape[0]
        with torch.no_grad():
            fk = smpl_forward(smpl, params["betas"].expand(N, 10), params["body_pose"],
                              params["global_orient"], params["transl"])
        np.save(args.save_mesh, fk["vertices"].cpu().numpy())
        faces_path = os.path.splitext(args.save_mesh)[0] + "_faces.npy"
        np.save(faces_path, smpl.faces)
        print(f"wrote mesh {args.save_mesh} (+{faces_path})")
    return {"params": params, "terms": terms, "losses": losses}


if __name__ == "__main__":
    main(sys.argv[1:])
