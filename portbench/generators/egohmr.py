"""EgoHMR test batches, one egocentric crop a sample, in the port's layout
(`seeme_tpu_torch/data/egohmr_images.py::to_model_batch`): an
ImageNet-normalized crop, a scene cloud new each batch (`scene_share` of its
points in a body-sized Gaussian around the person, the rest uniform over a
`room`-metre cube centred there, after the synthetic split's layout), the
OpenPose-25 keypoints whose confidences give the joints' visibility, a camera
and box in a 1920 x 1080 frame, and ground-truth SMPL parameters. The mix
gives `crops` (`size`, `mean`, `std`), `scene` (`scene_share`, `body_sigma`,
`room`), `visibility` (`lower_body`, `p_lower_body`, `p_joint`, `pelvis`),
`camera` (`fx`, `center`, `box`, `frame`) and `pose` (`betas`, `body_pose`,
`global_orient`, `transl_xy`, `depth`); the configuration gives the points
(`scene_points`) and the focal length's normalizer (`fx_norm_coeff`)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.systems import generator


def _uniform(g, shape, lo, hi, dev) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)


def batch(traffic, i: int) -> Dict:
    mix, dev, model = traffic.mix, traffic.device, traffic.conf["config"]["model"]
    g = generator(traffic.seed, "batch", dev, i)
    B, N = traffic.batch_size, int(model["scene_points"])
    crops, scene, vis, cam, pose = (mix[k] for k in ("crops", "scene", "visibility", "camera",
                                                     "pose"))
    S = int(crops["size"])
    mean = torch.tensor(crops["mean"], device=dev)
    std = torch.tensor(crops["std"], device=dev)
    img = (torch.rand(B, S, S, 3, generator=g, device=dev) - mean) / std

    transl = torch.cat([torch.randn(B, 2, generator=g, device=dev) * pose["transl_xy"],
                        _uniform(g, (B, 1), *pose["depth"], dev)], dim=-1)
    n_body = int(N * scene["scene_share"])
    body = torch.randn(B, n_body, 3, generator=g, device=dev) * torch.tensor(
        scene["body_sigma"], device=dev)
    room = _uniform(g, (B, N - n_body, 3), -scene["room"] / 2, scene["room"] / 2, dev)
    pcd = torch.cat([body, room], dim=1) + transl[:, None]

    conf = torch.ones(B, 25, device=dev)
    lower = torch.rand(B, 1, generator=g, device=dev) < vis["p_lower_body"]
    conf[:, vis["lower_body"]] *= (~lower).float()
    conf *= (torch.rand(B, 25, generator=g, device=dev) >= vis["p_joint"]).float()
    conf[:, vis["pelvis"]] = 1.0
    kp2d = torch.cat([torch.rand(B, 25, 2, generator=g, device=dev) - 0.5, conf[..., None]], -1)

    W, H = cam["frame"]
    fx = _uniform(g, (B,), *cam["fx"], dev)
    size = _uniform(g, (B,), *cam["box"], dev)
    frame = torch.tensor([W, H], dtype=torch.float32, device=dev)
    center = size[:, None] / 2 + torch.rand(B, 2, generator=g, device=dev) * (frame - size[:, None])
    return {
        "img": img,
        "scene_pcd": pcd,
        "fx": fx / float(model["fx_norm_coeff"]),
        "cam_cx": torch.full((B,), float(cam["center"][0]), device=dev),
        "cam_cy": torch.full((B,), float(cam["center"][1]), device=dev),
        "box_center": center,
        "box_size": size,
        "orig_keypoints_2d": kp2d,
        "smpl_params": {
            "betas": torch.randn(B, 10, generator=g, device=dev) * pose["betas"],
            "body_pose": torch.randn(B, 69, generator=g, device=dev) * pose["body_pose"],
            "global_orient": torch.randn(B, 3, generator=g, device=dev) * pose["global_orient"],
            "transl": transl,
        },
    }
