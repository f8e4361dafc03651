"""Text-to-motion (`seeme_tpu_torch/models/t2m.py::T2MSystem`)."""

from __future__ import annotations

from typing import Dict

from portbench.systems import make_stats


def make(conf: Dict, tree, seed: int, device):
    from seeme_tpu_torch.config import build as port_build
    from seeme_tpu_torch.models.t2m import T2MSystem

    cfg = port_build.t2m_config_from_yaml(tree, nfeats=conf["nfeats"])
    mean, std = make_stats(seed, cfg.nfeats, device)
    system = T2MSystem(cfg, mean, std, device=device,
                       seed=int(conf["config"].get("SEED_VALUE", 1234)))
    return system, None, mean, std
