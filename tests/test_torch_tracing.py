"""The port's spans and counters (`seeme_tpu_torch/utils/profiling.py`) on the
CPU: nothing recorded while no profiler records; under one, every layer span
of a small SEE-ME test batch with its parent, the three FK chains and the
host-sync sites; one denoise and one decode span per text-to-motion batch
on either route; the `seeme.*` ranges in the profiler's own events; the
same outputs traced and untraced; the test CLI's `--trace DIR`; and the
benchmark's readers of the spans and counters."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import registry
from portbench.harness import Readings
from seeme_tpu_torch.core.masks import lengths_to_mask
from seeme_tpu_torch.core.smpl import synthetic_smpl
from seeme_tpu_torch.data.humanml import SyntheticT2MDataset
from seeme_tpu_torch.data.synthetic import SyntheticEgoDataset, to_torch
from seeme_tpu_torch.eval.metrics import EgoMetric
from seeme_tpu_torch.models.seeme import SeeMeConfig, SeeMeSystem
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.test.__main__ import main
from seeme_tpu_torch.utils import profiling
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

B, W, STEPS, POINTS, T = 3, 32, 5, 64, 60
EGO = dict(latent_dim=(1, W), ff_size=16, num_layers=3, num_inference_timesteps=STEPS,
           scene_points=POINTS, scene_feat_dim=W)
TEXT, T2M_LEN = 48, 24
T2M = dict(latent_dim=(1, W), ff_size=16, num_layers=3, text_encoded_dim=TEXT, max_len=T2M_LEN,
           num_inference_timesteps=STEPS, guidance_scale=7.5)
TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3",
        "model.scene_points=64", "model.scene_feat_dim=32", "model.num_inference_timesteps=3"]
# each layer span of the ego test batch and its parent
EGO_PARENTS = {"encode": [], "encode.interactee": ["encode"], "encode.pointnet": ["encode"],
               "sample": [], "sample.precompute": ["sample"], "sample.denoise": ["sample"],
               "sample.decode": ["sample"], "joints": [], "joints.fk": ["joints"],
               "metric": []}
# the ego batch's sync sites: on the CPU kernel 3's plain twin runs the DDIM
# loop, whose scalar copies the kernel does not make on the card
EGO_SYNCS = {"host_sync.ddim_schedule": 3, "host_sync.smpl_parents": 3,
             "host_sync.smpl_parent_index": 3, "host_sync.smpl_bottom_row": 3,
             "host_sync.metric_index": 4, "host_sync.metric_tolist": 4,
             "host_sync.ddim_step_scalars": 2 * STEPS, "host_sync.predict_x0_table": STEPS}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.clear()
    yield
    profiling.clear()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def ego():
    data = SyntheticEgoDataset(B, T, scene_points=POINTS, seed=0)
    system = SeeMeSystem(SeeMeConfig(**EGO), synthetic_smpl(256), data.mean, data.std,
                         device="cpu", seed=1)
    return system, to_torch(data.batch(0, B), "cpu")


def ego_batch(system, batch):
    """The test CLI's timed batch: encode, sample, joints, metric."""
    z = torch.randn((B, 1, W), generator=torch.Generator().manual_seed(3))
    cond = system.encode_conditioning(batch)
    feats = system.sample_from_cond(cond, z_init=z)
    out = system.eval_fk(batch, feats)
    metric = EgoMetric(split="test")
    metric.update(out["joints_rst"], out["joints_ref"], out["quat_rst"], out["quat_ref"],
                  lengths_to_mask(batch["length"].long(), T))
    return cond, feats, out, metric.sums


def parents():
    """Each recorded span name -> the names of its parents."""
    return {k: v["parents"] for k, v in profiling.summary()["spans"].items()}


def test_nothing_is_recorded_without_a_profiler(ego):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("encode") is profiling.span("sample")   # the one shared no-op
    ego_batch(*ego)
    profiling.count("host_sync.anything")
    s = profiling.summary()
    assert s["spans"] == {} and s["counters"] == {}


def test_an_ego_batch_records_every_span_and_sync_site(ego):
    with traced():
        ego_batch(*ego)
    s = profiling.summary()
    assert parents() == EGO_PARENTS
    assert s["spans"]["joints.fk"]["count"] == 3
    assert all(v["count"] == 1 for k, v in s["spans"].items() if k != "joints.fk")
    assert s["counters"] == EGO_SYNCS
    for v in s["spans"].values():
        assert 0 <= v["device_self_ms"] <= v["device_ms"]
    enc = s["spans"]["encode"]
    inner = s["spans"]["encode.interactee"]["device_ms"] + s["spans"]["encode.pointnet"]["device_ms"]
    assert enc["device_self_ms"] == pytest.approx(enc["device_ms"] - inner)
    assert not torch.autograd._profiler_enabled()


def test_the_ranges_lie_in_the_profilers_events(ego):
    with traced() as prof:
        with profiling.span("batch", key=7):
            ego_batch(*ego)
    names = {e.name for e in prof.events()}
    assert {"seeme." + k for k in [*EGO_PARENTS, "batch"]} <= names
    assert parents()["encode"] == ["batch"]
    assert profiling.summary()["spans"]["batch"]["by_key"].keys() == {"7"}


def test_tracing_leaves_the_outputs_unchanged(ego):
    off = ego_batch(*ego)
    with traced():
        on = ego_batch(*ego)
    for a, b in zip(off[:2], on[:2]):
        assert torch.equal(a, b)
    for k in off[2]:
        assert torch.equal(off[2][k], on[2][k]), k
    assert off[3] == on[3]


@pytest.mark.parametrize("use_fused", [True, False], ids=["token_kernel", "loop"])
def test_t2m_sample_is_one_denoise_and_one_decode(use_fused):
    data = SyntheticT2MDataset(8, T2M_LEN, 8, seed=2, text_dim=TEXT)
    system = T2MSystem(T2MConfig(use_fused=use_fused, **T2M), data.mean, data.std, device="cpu",
                       seed=1)
    batch = data.batch(0, B)
    with traced():
        for _ in range(2):
            feats = system.sample(torch.as_tensor(batch["text_emb"]),
                                  lengths=torch.as_tensor(batch["length"]))
            system.feats_to_joints(feats)
    s = profiling.summary()
    spans = s["spans"]
    counts = {k: v["count"] for k, v in spans.items()}
    want = {"sample": 2, "sample.denoise": 2, "sample.decode": 2, "joints": 2, "joints.fk": 2}
    # the loop's scalar copies each step (on the CPU the token kernel's plain
    # version runs the same loop), and two quaternion inverses a recovery
    syncs = {"host_sync.ddim_step_scalars": 2 * 2 * STEPS,
             "host_sync.predict_x0_table": 2 * STEPS, "host_sync.ric_qinv": 2 * 2}
    if use_fused:
        want["sample.precompute"] = 2
        syncs["host_sync.ddim_schedule"] = 2 * 3
    assert counts == want
    assert s["counters"] == syncs
    assert spans["sample.denoise"]["parents"] == ["sample"]
    assert spans["joints.fk"]["parents"] == ["joints"]


def test_the_test_cli_writes_its_trace_and_spans(tmp_path):
    out = tmp_path / "trace"
    main(["--preset", "mld_egobody", "--device", "cpu", "--batch_size", "32",
          "--out", str(tmp_path / "run"), "--trace", str(out), "test.split='val'", *TINY])
    assert (out / "trace.json").stat().st_size > 0
    spans = json.loads((out / "spans.json").read_text())["spans"]
    n = spans["batch"]["count"]
    assert n >= 1 and sorted(spans["batch"]["by_key"], key=int) == [str(i) for i in range(n)]
    assert spans["encode"]["parents"] == ["batch"] and spans["joints.fk"]["count"] == 3 * n
    assert profiling.summary()["spans"] == {}        # written, then cleared


def read(name, batches=2):
    r = Readings(batches=batches, batch_size=B, spans_ms={}, trace=None, shapes={},
                 batch_flops=0.0)
    return registry.metric_reader(name).read(r)


SPAN_READERS = {"pointnet_ms": "encode.pointnet", "precompute_ms": "sample.precompute",
                "denoise_ms": "sample.denoise", "decode_ms": "sample.decode",
                "fk_ms": "joints.fk"}


@pytest.mark.parametrize("name", [*SPAN_READERS, "host_syncs"])
def test_readers_of_the_program_spans(name, ego):
    assert read(name) is None                        # nothing recorded
    with traced():
        for _ in range(2):
            ego_batch(*ego)
    s = profiling.summary()
    if name == "host_syncs":
        assert read(name) == sum(EGO_SYNCS.values())
    else:
        assert read(name) == pytest.approx(s["spans"][SPAN_READERS[name]]["device_ms"] / 2)
    assert read(name, batches=0) is None
