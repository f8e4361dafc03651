"""The fused PointNet blocks have no backward yet, so
`ops/pointnet_fused.py::FusedPointnet` refuses a call that would train the
scene encoder (grad mode on and an encoder parameter requiring grad) on
every route to them: ProHMR-Scene's and EgoHMR's `encode_scene` and
SEE-ME's `scene_features`. The frozen routes, SEE-ME's stage-2 training
step with the raw scene and the perception models' evaluation, still run.
CPU, plain versions of the blocks.
"""

import numpy as np
import pytest
import torch

from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from seeme_tpu_torch.models.prohmr import ProHMRConfig, ProHMRScene
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.nn.pointnet import ResnetPointnet
from seeme_tpu_torch.ops.pointnet_fused import FusedPointnet
from seeme_tpu_torch.train.loop import train_step
from seeme_tpu_torch.train.state import make_optimizer

POINTS = torch.as_tensor(np.random.RandomState(0).randn(2, 100, 3).astype(np.float32))


def perception_models():
    small = synthetic_smpl(32)
    return [ProHMRScene(ProHMRConfig(flow_hidden=8, flow_layers=1, flow_depth=1), small,
                        device="cpu"),
            EgoHmr(EgoHmrConfig(gcn_hid_dim=8, gcn_layers=0), small, device="cpu")]


@pytest.mark.parametrize("route", ["fused", "prohmr", "egohmr"])
def test_training_the_scene_encoder_raises(route):
    if route == "fused":
        net, encode = ResnetPointnet(32, hidden_dim=256), None
        fused = FusedPointnet()
        encode = lambda pts: fused(net, pts)  # noqa: E731
    else:
        model = perception_models()[route == "egohmr"]
        net, encode = model.scene_enc, model.encode_scene
    net.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward yet"):
        encode(POINTS)
    with torch.no_grad():  # evaluation under no_grad is fine
        assert torch.isfinite(encode(POINTS)).all()
    net.requires_grad_(False)  # frozen, grad mode on: fine
    assert torch.isfinite(encode(POINTS)).all()


def test_seeme_scene_route_is_guarded_and_its_frozen_training_runs():
    """Stage 2 at guidance 2.5 runs the PointNet every step (no cache): the
    step trains with the encoder frozen; `scene_features` refuses a
    trainable encoder only when grad mode reaches it."""
    data = SyntheticEgoDataset(3, 60, scene_points=64, seed=0)
    system = SeeMeSystem(SeeMeConfig(latent_dim=(1, 32), ff_size=16, num_layers=3,
                                     scene_points=64, scene_feat_dim=32, guidance_scale=2.5,
                                     dropout=0.0),
                         synthetic_smpl(256), data.mean, data.std, device="cpu")
    optimizer, schedule = make_optimizer("diffusion", system)
    assert not any(p.requires_grad for p in system.proscene.parameters())
    terms = train_step(system, "diffusion", optimizer, schedule, 0, to_torch(data.batch(0, 3), "cpu"),
                       torch.Generator().manual_seed(0))
    assert np.isfinite(terms["total"])
    system.proscene.requires_grad_(True)
    assert torch.isfinite(system.scene_features(torch.as_tensor(data.scene[:2]))).all()  # no_grad
    with pytest.raises(RuntimeError, match="no backward yet"):
        system._fused_scene(system.proscene["scene_enc"], torch.as_tensor(data.scene[:2]))
