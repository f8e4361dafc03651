"""The image-conditioned variant's feature cache and weights (helpers in
`torch_variants_common.py`; see `test_torch_variants.py`).
"""

import jax
import numpy as np
import torch

from seeme_tpu_torch.convert import from_jax_params
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.nn.init import perturb_parameters_
from torch_variants_common import (
    B,
    build,
    jax_params,
    VARIANTS,
)
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)


def test_image_cache_keys_leave_the_kernel_copies_alone():
    """Running the image encoder neither rebuilds the DDIM or PointNet
    kernel-layout copies nor is touched by them; a load of new weights
    reaches the image features."""
    data, system, _, _ = build(VARIANTS["image"])
    tb = to_torch(data.batch(0, B), "cpu")
    sd, ddim, scene = system.kernel_operands()
    feats = system.image_features(tb["image"])
    system.scene_features(tb["scene"])
    assert system.kernel_operands()[1] is ddim and system.kernel_operands()[2] is scene
    other = build(VARIANTS["image"])[1]
    perturb_parameters_(other, torch.Generator().manual_seed(9))
    system.load_state_dict(other.state_dict())
    assert not torch.equal(system.image_features(tb["image"]), feats)
    assert torch.equal(system.image_features(tb["image"]), other.image_features(tb["image"]))


def test_image_weights_carry_across():
    """A JAX image-config tree (image encoder params and batch stats,
    `output_images`) -> `from_jax_params` -> a strict `load_state_dict`,
    and back through the converters to the same tree."""
    data, system, jsystem, _ = build(VARIANTS["image"])
    shapes = jax.eval_shape(jsystem.init_params, jax.random.PRNGKey(5))
    rng = np.random.RandomState(6)
    tree = jax.tree.map(lambda s: rng.rand(*s.shape).astype(np.float32) + 0.5, shapes)
    sd = from_jax_params(tree)
    assert {k.split(".")[0] for k in sd} == {"vae", "denoiser", "proscene", "output_scene",
                                             "image_encoder", "output_images"}
    system.load_state_dict(sd, strict=True)
    back = jax_params(system)
    for key in ("image_encoder", "output_images"):
        assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
                                         back[key], tree[key])), key


def test_trainer_caches_image_features(tmp_path):
    """Stage 2 of `mld_egobody_image` on the CPU at a tiny size: the cache
    holds the ResNet50's features of every train and val sample (equal to
    the encoder's on the raw crops), batches carry them in place of the
    crops, the steps train `output_images` and leave the encoder bitwise
    alone."""
    from seeme_tpu_torch.train.__main__ import Trainer, parse_args

    tiny = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
            "model.scene_points=64", "model.scene_feat_dim=32", "model.image_size=32",
            "train.feature_cache=True", "train.val_every_steps=1"]
    tr = Trainer(parse_args(["--preset", "mld_egobody_image", "--device", "cpu", "--batch_size",
                             "64", "--epochs", "1", "--out", str(tmp_path), *tiny]))
    before = {k: v.clone() for k, v in tr.system.state_dict().items()}
    assert tr.fill_feature_cache() > 0
    cached = tr.datamodule.train_set.extras["image_feats"]
    assert cached.shape == (256, 2048) and tr.datamodule.val_set.extras["image_feats"].shape == (64, 2048)
    raw = torch.as_tensor(tr.datamodule.train_set.image[:3])
    np.testing.assert_allclose(cached[:3], tr.system.image_features(raw).numpy(), rtol=0,
                               atol=1e-5 * float(np.abs(cached).max()))
    batch = next(tr.train_batches(0))
    assert "image" not in batch and "scene" not in batch and batch["image_feats"].shape == (64, 2048)
    calls = []
    tr.system.image_encoder.register_forward_hook(lambda *a: calls.append(1))
    tr.fit()
    assert calls == [] and np.isfinite(tr.history[0]["val"]["total"])
    after = tr.system.state_dict()
    for k, v in after.items():
        if k.startswith(("image_encoder.", "vae.", "proscene.")):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(after["output_images.1.weight"], before["output_images.1.weight"])
