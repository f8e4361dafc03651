"""The cells at a size the CPU test run holds: two sequences a batch, one
warm-up batch, 128 scene points; every width as configured."""

from __future__ import annotations

import copy

from portbench import registry

SEED = 2**33 + 11


def shrink(monkeypatch, batch: int = 2, points: int = 128) -> None:
    traffic, config = registry.traffic, registry.config

    def small_traffic(name):
        return dict(traffic(name), batch=batch, warmup_batches=1, compare_batches=2)

    def small_config(bench, name, root=registry.ROOT):
        conf = copy.deepcopy(config(bench, name, root))
        model = conf["config"]["model"]
        if "scene_points" in model:
            model["scene_points"] = points
        return conf

    monkeypatch.setattr(registry, "traffic", small_traffic)
    monkeypatch.setattr(registry, "config", small_config)
