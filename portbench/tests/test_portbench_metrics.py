"""The metric arithmetic on fixed inputs: the rate over the window, the tail
over every batch, the trace's busy time, idle share and gaps, and each
per-layer reader."""

import pytest
from torch.autograd import DeviceType

from portbench import counts, registry
from portbench.harness import Readings, end_to_end
from portbench.trace import TraceSummary, summarize

MS = 1_000_000  # ns


class Ev:
    def __init__(self, name, start_ms, dur_ms, device=DeviceType.CPU, thread=1):
        self._n, self._s, self._d = name, start_ms * MS, dur_ms * MS
        self._dev, self._t = device, thread

    def name(self):
        return self._n

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._n.startswith("bench.")


def test_end_to_end():
    times = [0.010 * (k + 1) for k in range(100)]       # 10 .. 1000 ms
    m = end_to_end(times, batch=64, window_s=2.5, setup_s=7.0)
    assert m["samples_per_s"] == pytest.approx(100 * 64 / 2.5)
    assert m["batch_p95_ms"] == pytest.approx(950.5)    # numpy's linear percentile
    assert m["setup_s"] == 7.0


def synthetic_trace():
    cuda = DeviceType.CUDA
    return summarize([
        Ev("bench.window", 0, 100),
        Ev("bench.window", 0, 100, cuda),                 # the range repeated on the device
        Ev("bench.sample", 10, 40),
        Ev("aten::addmm", 12, 3),
        Ev("bench.joints", 60, 30),
        Ev("aten::bmm", 62, 20),
        Ev("void ddim_md_kernel<1>(float const*)", 15, 30, cuda),
        Ev("gemm", 40, 10, cuda),                         # overlaps the kernel by 5 ms
        Ev("gemm", 70, 5, cuda),
        Ev("Memcpy DtoH", 95, 10, cuda),                  # runs past the window's end
        Ev("void ddim_md_kernel<1>(float const*)", 200, 10, cuda),  # outside the window
    ])


def test_trace_busy_idle_and_gaps():
    t = synthetic_trace()
    assert t.window_s == pytest.approx(0.100)
    assert t.busy_s == pytest.approx((50 - 15 + 5 + 5) / 1e3)   # [15, 50], [70, 75], [95, 100]
    assert t.kernel("ddim_md_kernel") == (1, pytest.approx(0.030))
    assert t.kernel("gemm") == (2, pytest.approx(0.015))
    # gaps [0, 15] and [50, 70] begin outside every span, [75, 95] inside bench.joints' bmm
    assert t.gaps == {"between_batches": pytest.approx(0.035),
                      "bench.joints / aten::bmm": pytest.approx(0.020)}
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("void ddim_md_kernel_1_")
    assert len(bd["idle_gaps"]) == len(t.gaps) <= 10


def readings(trace, **shapes):
    base = {"batch": 64, "points": 20000, "hidden": 512, "n_cond": 2, "cond_rows": 64,
            "steps": 50, "tokens": 1, "width": 256, "layers": 5}
    base.update(shapes)
    return Readings(batches=10, batch_size=64, spans_ms={"scene": [70.0, 72.0], "sample": [17.0]},
                    trace=trace, shapes=base, batch_flops=9.9e11)


def read(name, r):
    return registry.metric_reader(name).read(r)


def test_readers():
    t = TraceSummary(window_s=1.0, busy_s=0.9, ops={"input_block_kernel<512>": (2, 0.04),
                                                    "split_block_kernel<512>": (6, 0.1)})
    r = readings(t)
    assert read("scene_ms", r) == pytest.approx(71.0)
    assert read("sample_ms", r) == pytest.approx(17.0)
    assert read("joints_ms", r) is None
    assert read("idle_share", r) == pytest.approx(10.0)
    assert read("mfu", r) == pytest.approx(100 * 9.9e11 * 10 / 1.0 / 989e12)
    shape = (64, 20000, 512)
    b1 = counts.bound_s(counts.input_block_flops(*shape), counts.input_block_bytes(*shape))
    b2 = counts.bound_s(counts.split_block_flops(*shape), counts.split_block_bytes(*shape))
    assert read("pointnet_roofline", r) == pytest.approx(100 * (2 * b1 + 6 * b2) / 0.14)
    assert read("ddim_md_roofline", r) is None


def test_readers_find_nothing_in_an_idle_trace():
    r = readings(TraceSummary(window_s=1.0, busy_s=0.0))
    assert read("idle_share", r) is None and read("mfu", r) is None
    assert read("pointnet_roofline", r) is None
