"""Shared helpers of the EgoHMR training tests (`tests/test_torch_egohmr_train*.py`).

EgoHMR training in the port against the JAX package, on the CPU, at the
root CLI's `--tiny` size (GCN 128 x 1 layer, 100 diffusion steps, 256 SMPL
vertices, 64 x 64 crops, 256 scene points): `training_loss` with the JAX
step's own draws (timesteps, noise, the condition drop) and one AdamW step
against optax, in float64 on both sides as in
`tests/test_torch_prohmr_train.py` (losses within 1e-5 relative, gradients
within 1e-4 of each tensor's max |g|, every updated tensor, batch
statistics included, within 1e-5 relative); the condition drop and the
capsule penetration term in float32; the training CLI against the root
`train_egohmr.py`; and the training constants of both perception models
against the JAX package's defaults.
"""

import jax
import numpy as np
import pytest

from seeme_tpu.core import synthetic_smpl as j_synthetic_smpl
from seeme_tpu.models.egohmr import EgoHmr as JEgoHmr
from seeme_tpu.models.egohmr import EgoHmrConfig as JEgoHmrConfig
from seeme_tpu_torch import train_egohmr as cli
from seeme_tpu_torch.convert import egohmr_state_dict
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from test_torch_hmr import VERTS, perturbed
from test_torch_prohmr_train import B
from tools import convert_checkpoint as cc

EGO = cli.TINY  # train_egohmr.py --tiny


@pytest.fixture(scope="module")
def egohmr():
    """The port's seeded weights as the JAX tree (`tools/convert_checkpoint.py`,
    as in `tests/test_torch_prohmr_train.py`), perturbed, loaded back."""
    jm = JEgoHmr(JEgoHmrConfig(**EGO), j_synthetic_smpl(n_verts=VERTS))
    port = EgoHmr(EgoHmrConfig(**EGO), synthetic_smpl(VERTS), device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    tree = perturbed(cc.convert_egohmr(sd, num_gcn_layers=cc.infer_gcn_layers(sd)), 5)
    port.load_state_dict(egohmr_state_dict(tree), strict=True)
    return jm, tree, port


def jax_draws(jm, key, n=B):
    """`training_loss`'s draws from its key (`seeme_tpu/models/egohmr.py:416-419`)."""
    t_rng, n_rng, m_rng = jax.random.split(key, 3)
    return {"t": np.array(jax.random.randint(t_rng, (n,), 0, jm.schedule.num_train_timesteps)),
            "noise": np.array(jax.random.normal(n_rng, (n, 144))),
            "drop": np.array(jax.random.bernoulli(m_rng, jm.cfg.cond_mask_prob,
                                                  (n, 1, 1))).reshape(n)}


def with_body_rep(port, b):
    """The batch with the CLI's `body_rep` target, numpy."""
    out = dict(b)
    out["body_rep"] = cli.add_body_rep(port, to_torch(b, "cpu"))["body_rep"].numpy()
    return out
