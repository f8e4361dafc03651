"""The port's action-to-motion evaluation against the JAX package on the
CPU: the HumanAct12 GRU evaluator on ragged lengths and the UESTC ST-GCN
with and without lengths against their flax modules, the spatial
adjacency, `ActionMetrics` / `UncondMetrics` on shared features, the state
dicts against the reference layouts `tools/convert_checkpoint.py` reads,
and the test CLI on both datasets at a tiny size.

Weights go from the port (seeded, perturbed, batch-norm statistics drawn)
through `convert_a2m_gru` / `convert_uestc_stgcn` to the flax modules.
Tolerances: 1e-5 of max |out| for the GRU, 1e-4 for the ST-GCN (ten
blocks of convolutions summed in another order), 1e-6 relative for the
metrics.
"""

import math

import jax
import numpy as np
import pytest
import torch

from seeme_tpu.eval.action_classifier import MotionDiscriminator as JGru
from seeme_tpu.eval.action_metrics import ActionMetrics as JActionMetrics
from seeme_tpu.eval.action_metrics import UncondMetrics as JUncondMetrics
from seeme_tpu.eval.action_metrics import diversity_times as j_diversity_times
from seeme_tpu.eval.stgcn import STGCN as JSTGCN
from seeme_tpu.eval.stgcn import smpl_spatial_adjacency as j_adjacency
from seeme_tpu_torch.convert import action_gru_state_dict, stgcn_state_dict
from seeme_tpu_torch.eval.action_classifier import MotionDiscriminator
from seeme_tpu_torch.eval.action_metrics import ActionMetrics, UncondMetrics, diversity_times
from seeme_tpu_torch.eval.stgcn import STGCN, smpl_spatial_adjacency
from seeme_tpu_torch.models import a2m as a2m_mod
from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
from seeme_tpu_torch.test.__main__ import main
from tools.convert_checkpoint import convert_a2m_gru, convert_uestc_stgcn
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

B, T = 4, 16
LENGTHS = np.array([T, 9, 3, 12])


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * float(np.abs(want).max()))


def seeded(module, seed):
    """Seeded init, perturbed, batch-norm statistics drawn away from (0, 1)."""
    init_parameters_(module, torch.Generator().manual_seed(seed))
    perturb_parameters_(module, torch.Generator().manual_seed(seed + 1))
    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("running_mean"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("running_var"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))
            elif "edge_importance" in name:
                p.add_(1.0)
    return module.eval()


def numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_gru_evaluator_matches_flax_on_ragged_lengths():
    """Each row's final state at its own length, zero initial state."""
    ours = seeded(MotionDiscriminator(), 3)
    motion = rand(4, B, T, 72)
    logits, feats = ours(torch.as_tensor(motion), torch.as_tensor(LENGTHS))
    jl, jf = jax.jit(lambda p, m, n: JGru().apply(p, m, n))(convert_a2m_gru(numpy_sd(ours)),
                                                            motion, LENGTHS)
    close(feats.detach().numpy(), jf, 1e-5)
    close(logits.detach().numpy(), jl, 1e-5)
    assert feats.shape == (B, 30) and logits.shape == (B, 12)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_stgcn_matches_flax(with_lengths):
    """(N, C, T, V) activations against the flax NTVC ones: data_bn, ten
    blocks (T 16 -> 4), the masked pool over ceil(length * t_out / T)
    frames, the classifier."""
    ours = seeded(STGCN(num_class=40), 5)
    motion = rand(6, B, T, 24, 6)
    lengths = LENGTHS if with_lengths else None
    logits, feats = ours(torch.as_tensor(motion),
                         None if lengths is None else torch.as_tensor(lengths))
    jl, jf = jax.jit(lambda p, m, n: JSTGCN(num_class=40).apply(p, m, n))(
        convert_uestc_stgcn(numpy_sd(ours)), motion, lengths)
    close(feats.detach().numpy(), jf, 1e-4)
    close(logits.detach().numpy(), jl, 1e-4)
    assert feats.shape == (B, 256)


def test_spatial_adjacency_matches_jax():
    """Three partitions over the SMPL tree, the inf == inf 'root' quirk kept."""
    ours = smpl_spatial_adjacency()
    np.testing.assert_array_equal(ours, j_adjacency())
    assert ours.shape == (3, 24, 24) and ours[2].sum() > 0


@pytest.mark.parametrize("kind", ["gru", "stgcn"])
def test_state_dict_is_the_reference_layout(kind):
    """Every key the converter reads is a port key and nothing else is
    (num_batches_tracked and the ST-GCN's `A` are not read); through the
    converter and back every tensor is bitwise the same."""
    ours = seeded(MotionDiscriminator() if kind == "gru" else STGCN(), 7)
    sd = numpy_sd(ours)
    convert, back = ((convert_a2m_gru, action_gru_state_dict) if kind == "gru"
                     else (convert_uestc_stgcn, stgcn_state_dict))
    read = set()

    class Recording(dict):
        def __getitem__(self, k):
            read.add(k)
            return dict.__getitem__(self, k)

    tree = convert(Recording(sd))
    assert read == set(sd)
    again = back(jax.tree.map(np.asarray, tree))
    assert set(again) == set(sd)
    for k, v in again.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    if kind == "stgcn":
        assert {k for k in sd if k.startswith("st_gcn_networks.4.residual")} == {
            f"st_gcn_networks.4.residual.{i}.{n}" for i, names in
            ((0, ("weight", "bias")), (1, ("weight", "bias", "running_mean", "running_var")))
            for n in names}
        assert not any(k.startswith(("st_gcn_networks.0.residual", "st_gcn_networks.1.residual"))
                       for k in sd)


def test_action_metrics_match_jax():
    """FID, accuracy, Diversity and MultiModality over two batches, the
    pairs drawn from the same seeded stream."""
    labels = np.random.RandomState(1).randint(0, 5, 60)
    ours, ref = ActionMetrics(num_classes=5), JActionMetrics(num_classes=5)
    for m in (ours, ref):
        m.update(rand(2, 40, 30), rand(3, 40, 30), rand(4, 40, 5), labels[:40])
        m.update(rand(5, 20, 30), rand(6, 20, 30), rand(7, 20, 5), labels[40:])
    got, want = ours.compute(), ref.compute()
    assert set(got) == set(want) == {"accuracy", "FID", "Diversity", "MultiModality"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    ours.reset()
    with pytest.raises(RuntimeError, match="no accumulated batches"):
        ours.compute()


def test_uncond_metrics_and_diversity_times_match_jax():
    ours, ref = UncondMetrics(), JUncondMetrics()
    for m in (ours, ref):
        m.update(rand(8, 50, 16), rand(9, 50, 16))
    got, want = ours.compute(), ref.compute()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for n, c in ((10, 12), (50, 40), (3, 1)):
        assert diversity_times(n, c) == j_diversity_times(n, c)


TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        f"model.num_frames={T}", "model.num_inference_timesteps=4"]


@pytest.mark.parametrize("preset,clf", [("mld_humanact12", "gru"), ("mld_uestc", "stgcn")])
def test_cli_evaluates_on_the_cpu(preset, clf, tmp_path, monkeypatch):
    """`python -m seeme_tpu_torch.test --device cpu` at a tiny size, 2
    replications over the 60-sample synthetic test split (one batch of 64,
    the padded tail not counted): kernel 5's route once a batch and
    replication, finite FID / accuracy / Diversity / MultiModality; the
    UESTC run loads its ST-GCN from a file with the reference's keys."""
    calls = []
    fused = a2m_mod.ddim_fused_tok
    monkeypatch.setattr(a2m_mod, "ddim_fused_tok", lambda *a, **k: calls.append(1) or fused(*a, **k))
    extra = []
    if clf == "stgcn":
        sd = seeded(STGCN(), 11).state_dict()
        sd.update({"A": torch.as_tensor(smpl_spatial_adjacency()),
                   "data_bn.num_batches_tracked": torch.tensor(0)})
        torch.save({"state_dict": sd}, tmp_path / "uestc_stgcn.tar")
        extra = [f"test.evaluator_checkpoint='{tmp_path / 'uestc_stgcn.tar'}'"]
    result = main(["--preset", preset, "--device", "cpu", "--out", str(tmp_path / "out"),
                   "--replication_times", "2", *TINY, *extra])
    assert len(calls) == 2
    stats = result["stats"]
    assert set(stats) == {"accuracy", "FID", "Diversity", "MultiModality"}
    assert all(math.isfinite(x) for v in stats.values() for x in v.values())
    assert len(result["replications"]) == 2
    log = (tmp_path / "out" / "test_log.txt").read_text()
    assert ("loaded evaluator" in log) == (clf == "stgcn")


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--preset", "mld_uestc", "--out", str(tmp_path)])
