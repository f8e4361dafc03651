"""EgoHMR's test path under the port's spans and counters
(`seeme_tpu_torch/utils/profiling.py`) on the CPU: nothing recorded while no
profiler records; under one, each batch of `test_egohmr.evaluate_batch`
records the encode, sample and joints spans with their children and every
host-sync site, two scalar copies a DDPM step among them; `EgoHmr.sample`
gives bitwise what it gave before it carried spans, traced or not; and the
test CLI prints the metrics of the loop it had before `evaluate_batch`."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seeme_tpu_torch import test_egohmr as cli
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.batch import eval_batches
from seeme_tpu_torch.data.egohmr_images import EgoHmrImageDataModule
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.eval.hmr_metrics import HmrMetrics
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig
from seeme_tpu_torch.test_prohmr_scene import ground_truth
from seeme_tpu_torch.utils import profiling

TINY = dict(gcn_hid_dim=128, gcn_layers=1, num_train_timesteps=100,
            timestep_respacing="ddim10")   # test_egohmr.py --tiny
STEPS, B = 10, 4
# each span of a batch, its parents and its count a batch: `joints` and
# `joints.fk` twice, for the final forward and the ground truth
SPANS = {"encode": ([], 1), "encode.image": (["encode"], 1), "encode.pointnet": (["encode"], 1),
         "sample": ([], 1), "sample.denoise": (["sample"], 1), "joints": ([], 2),
         "joints.fk": (["joints"], 2)}
# each sync site's count a batch: the SMPL chain's three in each of two chains
SYNCS = {"host_sync.ddpm_step_scalars": 2 * STEPS, "host_sync.visibility_index": 2,
         "host_sync.smpl_parents": 2, "host_sync.smpl_parent_index": 2,
         "host_sync.smpl_bottom_row": 2, "host_sync.hmr_readback": 5}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def tiny():
    smpl = synthetic_smpl(n_verts=256)
    model = EgoHmr(EgoHmrConfig(**TINY), smpl, device="cpu")
    dm = EgoHmrImageDataModule(n_pts=64, img_size=32, smpl=smpl)
    batch, n_valid = next(eval_batches(dm, "test", B))
    return model, to_torch(batch, "cpu"), n_valid


def run(model, batch, n_valid, batches=1):
    gen = torch.Generator().manual_seed(cli.NOISE_SEED)
    metrics = HmrMetrics()
    outs = [cli.evaluate_batch(model, batch, gen, metrics, n_valid) for _ in range(batches)]
    return outs, metrics.compute()


def parent_sample(model, batch, generator):
    """`EgoHmr.sample` as it was before its spans and counters."""
    sched = model.sample_schedule
    enc = model.encode(batch)
    vis_mask = model.visibility_mask(batch)
    cond = model.conditioning(enc, vis_mask)
    cond_uncond = model.mask_cond(cond)
    vis6 = vis_mask.repeat_interleave(6, dim=-1)
    x = torch.randn(B, 144, generator=generator)
    for t in range(sched.num_train_timesteps - 1, -1, -1):
        model_t = torch.full((B,), int(model.timestep_map[t]), dtype=torch.long)
        pred = model._fused_x0(cond, cond_uncond, vis6, x, model_t)
        eps = torch.randn(B, 144, generator=generator) if t > 0 else None
        x = sched.ddpm_step(pred, t, x, eps)
    return model.forward(batch, x, torch.zeros(B, dtype=torch.long), eval_with_uncond=True,
                         enc=enc)


def test_nothing_is_recorded_without_a_profiler(tiny):
    assert not torch.autograd._profiler_enabled()
    run(*tiny)
    s = profiling.summary()
    assert s["spans"] == {} and s["counters"] == {}


def test_each_batch_records_its_spans_and_sync_sites(tiny):
    with profile(activities=[ProfilerActivity.CPU]):
        run(*tiny, batches=2)
    s = profiling.summary()
    assert {k: (v["parents"], v["count"]) for k, v in s["spans"].items()} == \
        {k: (p, 2 * n) for k, (p, n) in SPANS.items()}
    assert s["counters"] == {k: 2 * n for k, n in SYNCS.items()}
    for v in s["spans"].values():
        assert 0 <= v["device_self_ms"] <= v["device_ms"]
    assert not torch.autograd._profiler_enabled()


def test_sample_is_bitwise_the_parents_traced_or_not(tiny):
    model, batch, _ = tiny
    with torch.no_grad():
        want = parent_sample(model, batch, torch.Generator().manual_seed(5))
    off = model.sample(batch, generator=torch.Generator().manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]):
        on = model.sample(batch, generator=torch.Generator().manual_seed(5))
    for got in (off, on):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k == "pred_smpl_params":
                assert all(torch.equal(got[k][p], v[p]) for p in v), k
            else:
                assert torch.equal(got[k], v), k


def test_cli_prints_the_parents_metrics(capsys):
    """`main --tiny --device cpu` against its loop before `evaluate_batch`:
    sample, ground truth, five read-backs, `HmrMetrics.update`."""
    got = cli.main(["--tiny", "--device", "cpu"])
    printed = capsys.readouterr().out
    smpl = synthetic_smpl(n_verts=256)
    model = EgoHmr(EgoHmrConfig(**TINY), smpl, device="cpu")
    dm = EgoHmrImageDataModule(n_pts=1024, img_size=64, smpl=smpl)
    gen = torch.Generator().manual_seed(1)
    metrics = HmrMetrics()
    with torch.no_grad():
        for batch_np, n_valid in eval_batches(dm, "test", 8):
            batch = to_torch(batch_np, "cpu")
            out = model.sample(batch, generator=gen)
            gt_j, gt_v = ground_truth(model, batch)
            host = lambda t: t[:n_valid].cpu().numpy()  # noqa: E731
            metrics.update(host(out["pred_keypoints_3d"][:, :24]), host(out["pred_vertices"]),
                           host(gt_j), host(gt_v), host(out["vis_mask_smpl"]))
    want = metrics.compute()
    assert got == want
    assert printed.splitlines()[-len(want):] == [f"{k}: {v:.2f} mm" for k, v in want.items()]
