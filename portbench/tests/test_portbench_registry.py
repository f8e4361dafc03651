"""The registry finds every configuration, traffic mix, reference and metric
reader that BENCHMARK.json names, and the system, route and generator that
those files name; and the file keeps the benchmark's rules."""

import json
import re

import pytest

from portbench import counts, registry
from portbench.routes import Route

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found(entry):
    conf = registry.config(BENCH, entry["name"])
    assert conf["name"] == entry["name"] and conf["reduced"] == entry["reduced"]
    assert entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert callable(registry.system(conf["system"]).make)
    ref = registry.reference(entry["name"])
    assert callable(getattr(ref, "encode", None) or ref.sample) and ref.LIMITS


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found(cell):
    mix = registry.traffic(cell["traffic"])
    assert issubclass(registry.route(mix["route"]), Route) and mix["batch"] > 0
    assert callable(registry.generator(mix["generator"]).batch)
    assert registry.workload(BENCH, cell["name"]) == cell
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    reported = {m["name"] for m in registry.cell_metrics(BENCH, cell["name"], "end_to_end")}
    assert {"setup_s", "samples_per_s"} <= reported
    assert registry.cell_metrics(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert callable(registry.metric_reader(metric["name"]).read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.workload(BENCH, "no.such.cell")
    for find in (registry.metric_reader, registry.system, registry.route, registry.generator):
        with pytest.raises(FileNotFoundError):
            find("no_such_name")
    with pytest.raises(FileNotFoundError):
        registry.route("..routes")


def test_benchmark_file_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024 and 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_peaks():
    assert counts.PEAK_FLOPS == 989e12 and counts.PEAK_BYTES == 3.35e12
