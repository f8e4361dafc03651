"""SEE-ME (`seeme_tpu_torch/models/seeme.py::SeeMeSystem`) over the
benchmark's synthetic SMPL body."""

from __future__ import annotations

from typing import Dict

from portbench.systems import make_body, make_stats


def make(conf: Dict, tree, seed: int, device):
    from seeme_tpu_torch.config import build as port_build
    from seeme_tpu_torch.core.smpl import SmplModel
    from seeme_tpu_torch.models.seeme import SeeMeSystem

    cfg = port_build.seeme_config_from_yaml(tree)
    body = make_body(seed, device, conf["smpl_vertices"], conf["smpl_betas"])
    smpl = SmplModel(v_template=body["v_template"], shapedirs=body["shapedirs"],
                     posedirs=body["posedirs"], j_regressor=body["j_regressor"],
                     lbs_weights=body["lbs_weights"], parents=body["parents"])
    mean, std = make_stats(seed, cfg.nfeats, device)
    system = SeeMeSystem(cfg, smpl, mean, std, device=device,
                         seed=int(conf["config"].get("SEED_VALUE", 1234)))
    return system, body, mean, std
