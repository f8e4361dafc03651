"""`t2m_text`: text-to-motion evaluation. `T2MSystem.sample(text_emb,
lengths)` -> `feats_to_joints` of the sample and of the reference motion ->
each sequence's root-aligned MPJPE over its valid frames, read back.
Compared: the DDIM latents, the decoded features and the joints over each
sequence's valid frames."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import plain
from portbench.routes import Route, Spans


class T2MText(Route):
    compared = ("latent", "feats", "joints")

    def __init__(self, *args):
        super().__init__(*args)
        self.T = int(self.conf["config"]["DATASET"]["SAMPLER"]["MAX_LEN"])
        self.errors: List[float] = []

    def prepare(self, i: int) -> Dict:
        return {"batch": self.traffic.batch(i), "z": self.traffic.noise(i)}

    def run(self, inp: Dict, spans: Spans) -> Dict:
        s, batch = self.system, inp["batch"]
        with spans("sample"):
            feats = s.sample(batch["text_emb"], lengths=batch["length"], z_init=inp["z"])
        latent = self._latent
        with spans("joints"):
            pred, ref = s.feats_to_joints(feats), s.feats_to_joints(batch["motion"])
            valid = (torch.arange(self.T, device=feats.device)[None]
                     < batch["length"][:, None]).to(pred.dtype)
            err = ((pred - pred[:, :, :1]) - (ref - ref[:, :, :1])).norm(dim=-1).mean(-1)
            mpjpe = (err * valid).sum(1) / valid.sum(1) * 1000.0
            self.errors.extend(mpjpe.tolist())
        return {"latent": latent, "feats": feats, "joints": pred, "joints_ref": ref}

    def program(self, out: Dict) -> Dict[str, torch.Tensor]:
        return {"latent": out["latent"], "feats": out["feats"],
                "joints": torch.stack([out["joints"], out["joints_ref"]])}

    def masks(self, inp) -> Dict[str, torch.Tensor]:
        valid = torch.arange(self.T, device=inp["z"].device)[None] < inp["batch"]["length"][:, None]
        return {"feats": valid, "joints": torch.stack([valid, valid])}

    def reference(self, ar: plain.Arith, inp: Dict) -> Dict[str, torch.Tensor]:
        b, r, batch = self.built, self.refm, inp["batch"]
        latent, feats = r.sample(ar, b.weights, self.conf, batch["text_emb"], batch["length"],
                                 inp["z"])
        joints = torch.stack([r.joints(self.conf, b.mean, b.std, feats),
                              r.joints(self.conf, b.mean, b.std, batch["motion"])])
        return {"latent": latent, "feats": feats, "joints": joints}

    def shapes(self) -> Dict:
        return dict(super().shapes(), n_cond=1)


ROUTE = T2MText
