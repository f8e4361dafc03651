"""The benchmark's `egohmr.test` cell on the CPU at a small size (a GCN 64
wide with one residual block, ddim10 over 100 steps, 64 x 64 crops, 512
scene points, a 256-vertex body, four crops a batch; every other width as
published): the route's run of `EgoHmr` through the test CLI's
`evaluate_batch` against the plain reference (`portbench/reference/
egohmr-egobody.py`) comes out correct, and not correct under each planted
fault and under the TF32 control; the reverse process's count
(`portbench/counts_gcn.py`) against FlopCounterMode over the reference's
step; the readers of `image_ms` and `gcn_roofline`; and a traced run, in
a process of its own, loading no JAX and reporting every per-layer metric
that the CPU can read."""

import copy
import json
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import counts, counts_gcn, harness, registry
from portbench.harness import Readings
from portbench.reference import plain
from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
from seeme_tpu_torch.models.egohmr import EgoHmr, EgoHmrConfig, InputProcess, TimestepEmbedder
from seeme_tpu_torch.nn import gcn
from seeme_tpu_torch.utils import profiling

CELL, SEED = "egohmr.test", 2**33 + 11
SMALL = dict(gcn_hid_dim=64, gcn_layers=1, num_train_timesteps=100, timestep_respacing="ddim10",
             scene_points=512)


def shrink(monkeypatch):
    traffic, config = registry.traffic, registry.config

    def small_traffic(name):
        mix = dict(traffic(name), batch=4, warmup_batches=1, compare_batches=2)
        mix["crops"] = dict(mix["crops"], size=64)
        return mix

    def small_config(bench, name, root=registry.ROOT):
        conf = copy.deepcopy(config(bench, name, root))
        conf["config"]["model"].update(SMALL)
        conf["smpl_vertices"] = 256
        return conf

    monkeypatch.setattr(registry, "traffic", small_traffic)
    monkeypatch.setattr(registry, "config", small_config)


@pytest.fixture
def small(monkeypatch):
    shrink(monkeypatch)


def test_route_matches_reference(small):
    r = harness.run_cell(CELL, SEED, 0.05, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4, r["compared"]
    assert set(r["compared"]) == {"feats", "pose", "joints", "vertices"}
    for name, c in r["compared"].items():
        assert c["value"] <= c["limit"], (name, c)


# ----------------------------------------------------------------- faults
def block_skipped(mp):
    mp.setattr(gcn.ResGraphConv, "forward", lambda self, x: x)


def fusion_blind(mp):
    mp.setattr(EgoHmr, "_fused_x0",
               lambda self, cond, cond_uncond, vis6, x, t: self.denoise(cond, x, t))


def state_unchanged(mp):
    mp.setattr(DiffusionSchedule, "ddpm_step", lambda self, out, t, sample, noise: sample)


def noise_replaced(mp):
    """Sample 0's initial state and steps' noise those of the last sample."""
    real = EgoHmr.sample

    def sample(self, batch, generator=None, x_init=None, noise=None):
        draws = [torch.randn(batch["img"].shape[0], 144, generator=generator, device=self.device)
                 for _ in range(self.sample_schedule.num_train_timesteps)]
        for d in draws:
            d[0] = d[-1]
        return real(self, batch, x_init=draws[0], noise=draws[1:])

    mp.setattr(EgoHmr, "sample", sample)


@pytest.mark.parametrize("fault", [block_skipped, fusion_blind, state_unchanged, noise_replaced],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(small, fault, monkeypatch):
    fault(monkeypatch)
    r = harness.run_cell(CELL, SEED, 0.05, False, "cpu")
    assert not r["correct"], r["compared"]


def test_control_is_not_correct(small):
    gaps = harness.control_cell(CELL, SEED, "cpu")
    limits = registry.reference("egohmr-egobody").LIMITS
    assert all(gaps[n] > limits[n] for n in limits), (gaps, limits)


# ------------------------------------------------------------------ counts
def reverse_state_dict(cfg: EgoHmrConfig):
    """The reverse process's weights as a system state dict has them, on the
    meta device."""
    with torch.device("meta"):
        parts = {"diffusion_model": gcn.ModulatedGCN(cfg.gcn_in_dim, gcn.smpl_adjacency(),
                                                     cfg.gcn_hid_dim, 6, cfg.gcn_layers),
                 "embed_timestep": TimestepEmbedder(cfg.timestep_embed_dim),
                 "input_process": InputProcess(cfg.input_process_dim)}
    return {f"{p}.{k}": torch.empty(v.shape, device="meta")
            for p, m in parts.items() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("case", ["published", "small"])
def test_counts_gcn_matches_flop_counter(case):
    cfg = EgoHmrConfig() if case == "published" else EgoHmrConfig(
        **{k: v for k, v in SMALL.items() if k != "scene_points"})
    B = 64 if case == "published" else 3
    ref = registry.reference("egohmr-egobody")
    sd = reverse_state_dict(cfg)
    cond2 = torch.empty(2 * B, 24, cfg.context_dim, device="meta")
    x = torch.empty(B, 144, device="meta")
    adj = ref.adjacency("meta")
    step = counts.counted_flops(lambda: ref.denoise(plain.Arith(), sd, cond2, x, 980, adj))
    shapes = counts_gcn.gcn_shapes(sd)
    assert counts_gcn.step_flops(shapes, B) == pytest.approx(step, rel=1e-12)
    if case == "published":      # 7.6 TFLOP over 50 steps: 7.7 ms at the bf16 peak
        flops = counts_gcn.reverse_flops(shapes, B, 50)
        nbytes = counts_gcn.reverse_bytes(counts_gcn.gcn_numels(sd), B, 50, cfg.context_dim)
        assert 7.4e12 < flops < 7.8e12 and nbytes < 0.2e9
        assert counts.bound_s(flops, nbytes) == flops / counts.PEAK_FLOPS


# ----------------------------------------------------------------- readers
def readings(batches, shapes=None):
    return Readings(batches=batches, batch_size=4, spans_ms={}, trace=None,
                    shapes=shapes or {}, batch_flops=0.0)


@pytest.fixture
def recorded():
    """`encode.image` and `sample.denoise` spans recorded twice each."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            for name in ("encode.image", "sample.denoise"):
                with profiling.span(name):
                    time.sleep(0.002)
    yield profiling.summary()["spans"]
    profiling.clear()


def test_image_ms_reader(recorded):
    read = registry.metric_reader("image_ms").read
    assert read(readings(2)) == pytest.approx(recorded["encode.image"]["device_ms"] / 2)
    assert read(readings(0)) is None
    profiling.clear()
    assert read(readings(2)) is None


def test_gcn_roofline_reader(recorded):
    read = registry.metric_reader("gcn_roofline").read
    sd = reverse_state_dict(EgoHmrConfig())
    shapes = {"batch": 64, "steps": 50, "gcn_shapes": counts_gcn.gcn_shapes(sd),
              "gcn_numels": counts_gcn.gcn_numels(sd), "cond_width": 2694}
    flops = counts_gcn.reverse_flops(shapes["gcn_shapes"], 64, 50)
    per_batch_s = recorded["sample.denoise"]["device_ms"] / 2 / 1e3
    want = 100.0 * flops / counts.PEAK_FLOPS / per_batch_s
    assert read(readings(2, shapes)) == pytest.approx(want)
    assert read(readings(2)) is None                 # a cell without the GCN
    assert read(readings(0, shapes)) is None
    profiling.clear()
    assert read(readings(2, shapes)) is None         # no span recorded


RUN = """
import sys, json
sys.path.insert(0, {root!r})
import pytest
sys.path.insert(0, {tests!r})
from test_portbench_egohmr import SEED, CELL, shrink
from portbench import harness
shrink(pytest.MonkeyPatch())
r = harness.run_cell(CELL, SEED, 0.05, True, "cpu")
roots = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps([r["correct"], sorted(r["metrics"]), roots]))
"""


def test_a_traced_run_loads_no_jax():
    code = RUN.format(root=str(registry.ROOT), tests=str(registry.ROOT / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    correct, metrics, roots = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and "seeme_tpu_torch" in roots
    assert not set(roots) & set(harness.BANNED)
    # on the CPU no device operation is traced: the device's metrics read nothing
    assert metrics == ["denoise_ms", "fk_ms", "gcn_roofline", "host_syncs", "image_ms",
                       "joints_ms", "pointnet_ms"]
