"""`ego_fresh`: the EgoBody test CLI's `--count_time` batch
(`seeme_tpu_torch/test/__main__.py::Evaluator.run`):
`SeeMeSystem.encode_conditioning` -> `sample_from_cond` -> `eval_fk` ->
`EgoMetric.update`, whose read-back ends the batch. Compared: the condition
tokens, the DDIM latents, the decoded features and the SMPL joints of the
prediction, the wearer and the interactee."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import plain
from portbench.routes import Route, Spans


class EgoFresh(Route):
    compared = ("cond", "latent", "feats", "joints")

    def __init__(self, *args):
        super().__init__(*args)
        from seeme_tpu_torch.core.masks import lengths_to_mask
        from seeme_tpu_torch.eval.metrics import EgoMetric

        self.lengths_to_mask = lengths_to_mask
        self.metric = EgoMetric(split="test")
        self.T = int(self.conf["config"]["MOTION_LENGTH"])

    def prepare(self, i: int) -> Dict:
        return {"batch": self.traffic.batch(i), "z": self.traffic.noise(i)}

    def run(self, inp: Dict, spans: Spans) -> Dict:
        s, batch = self.system, inp["batch"]
        with spans("scene"):
            cond = s.encode_conditioning(batch)
        with spans("sample"):
            feats = s.sample_from_cond(cond, z_init=inp["z"])
        latent = self._latent
        with spans("joints"):
            out = s.eval_fk(batch, feats)
            mask = self.lengths_to_mask(batch["length"].long(), self.T)
            self.metric.update(out["joints_rst"], out["joints_ref"], out["quat_rst"],
                               out["quat_ref"], mask)
        return {"cond": cond, "latent": latent, "feats": feats,
                "joints": out["joints_rst"], "joints_ref": out["joints_ref"],
                "joints_int": out["joints_int"]}

    def program(self, out: Dict) -> Dict[str, torch.Tensor]:
        return {"cond": out["cond"], "latent": out["latent"], "feats": out["feats"],
                "joints": torch.stack([out["joints"], out["joints_ref"], out["joints_int"]])}

    def reference(self, ar: plain.Arith, inp: Dict) -> Dict[str, torch.Tensor]:
        b, r = self.built, self.refm
        cond = r.encode(ar, b.weights, self.conf, inp["batch"])
        latent, feats = r.sample(ar, b.weights, self.conf, cond, inp["z"])
        return {"cond": cond, "latent": latent, "feats": feats,
                "joints": r.joints(ar, b.body, b.mean, b.std, inp["batch"], feats)}

    def shapes(self) -> Dict:
        return dict(super().shapes(), n_cond=len(self.model["condition"]),
                    points=int(self.model["scene_points"]),
                    hidden=int(self.conf["pointnet_hidden"]))


ROUTE = EgoFresh
