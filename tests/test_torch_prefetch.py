"""Host-to-device prefetching on the CPU: the look-ahead's order, its
`size` (how many batches are staged before one is handed out, against the
JAX package's queue), the last partial batch, captions and nested entries
passing through, the plain conversion on a CPU device, and `run_epoch`
giving the same terms and weights through it as a loop of
`train_step(to_torch(b))` (bitwise: the same arithmetic on the same
tensors). The CUDA side (pinned staging, side stream, events) runs in
`tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

from seeme_tpu.data import prefetch as jprefetch
from seeme_tpu_torch.config.presets import PRESETS, apply_overrides, build
from seeme_tpu_torch.data.prefetch import lookahead, prefetch_to_device
from seeme_tpu_torch.data.synthetic import to_torch
from seeme_tpu_torch.train.loop import run_epoch, train_step
from seeme_tpu_torch.train.state import make_optimizer
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

TINY = ["model.latent_dim=(1, 32)", "model.ff_size=16", "model.num_layers=3"]


def batches(n, bs=4, last=None):
    rng = np.random.RandomState(0)
    for i in range(n):
        b = bs if (last is None or i < n - 1) else last
        yield {"motion": rng.randn(b, 5, 3).astype(np.float32),
               "length": np.full(b, 5, np.int32),
               "text": [f"caption {i} {j}" for j in range(b)],
               "extra": {"scene": rng.randn(b, 7, 3).astype(np.float32)}}


@pytest.mark.parametrize("size", [1, 2, 5])
def test_lookahead_stages_size_batches_like_the_jax_queue(size, monkeypatch):
    ours = []
    for item in lookahead(range(4), lambda x: ours.append(("put", x)) or x, size):
        ours.append(("get", item))
    ref = []  # the JAX queue, its device_put logged instead of run
    monkeypatch.setattr(jprefetch.jnp, "asarray", lambda v: v)
    monkeypatch.setattr(jprefetch.jax, "device_put", lambda v: ref.append(("put", v)) or v)
    for b in jprefetch.prefetch_to_device(({"x": i} for i in range(4)), size=size):
        ref.append(("get", b["x"]))
    assert ours == ref
    assert [x for op, x in ours if op == "get"] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="size 0"):
        list(lookahead(range(2), lambda x: x, 0))


def test_cpu_prefetch_is_the_plain_conversion():
    host = list(batches(3, last=2))
    got = list(prefetch_to_device(iter(host), "cpu", size=2))
    assert len(got) == 3 and got[-1]["motion"].shape[0] == 2   # the last partial batch
    for g, h in zip(got, host):
        want = to_torch(h, "cpu")
        for k in ("motion", "length"):
            assert torch.equal(g[k], want[k]) and g[k].dtype == want[k].dtype
        assert g["text"] == h["text"]                              # captions untouched
        assert torch.equal(g["extra"]["scene"], torch.as_tensor(h["extra"]["scene"]))
    assert list(prefetch_to_device(iter([]), "cpu")) == []


def test_run_epoch_terms_unchanged_through_prefetch():
    """`run_epoch` (prefetched) against a loop of `train_step(to_torch(b))`
    from the same weights, optimizer state and generator seed."""
    preset = apply_overrides(PRESETS["vae_humanact12"](), TINY + ["model.num_frames=16"])
    runs = []
    for _ in range(2):
        dm, system = build(preset, torch.device("cpu"))
        opt, sched = make_optimizer("vae", system, lr=1e-3)
        gen = torch.Generator().manual_seed(5)
        runs.append((dm, system, opt, sched, gen))
    host = list(runs[0][0].batches("train", 16, seed=3))[:4]
    dm, system, opt, sched, gen = runs[0]
    torch.manual_seed(7)  # dropout draws from the default generator
    count, means, steps, ms = run_epoch(system, "vae", opt, sched, 0, iter(host), gen)
    dm2, system2, opt2, sched2, gen2 = runs[1]
    torch.manual_seed(7)
    want = [train_step(system2, "vae", opt2, sched2, i, to_torch(b, "cpu"), gen2)
            for i, b in enumerate(host)]
    assert count == 4 and len(ms) == 4 and steps == want
    for (k, a), b in zip(system.state_dict().items(), system2.state_dict().values()):
        assert torch.equal(a, b), k
