"""`egohmr_crops`: the EgoHMR test CLI's batch
(`seeme_tpu_torch/test_egohmr.py::evaluate_batch`): `EgoHmr.sample` (the
encode, the respaced ancestral steps fused by visibility, the final forward
and SMPL), the ground truth's SMPL, the read-backs and `HmrMetrics.update`.
Each batch's noise comes from a generator seeded from (seed, batch), which
the reference replays. Compared: the encoded features, the final normalized
rot6d, and the predicted SMPL joints and vertices.

The class does its own set-up and does not call `Route.__init__`, which
wraps `system.vae.decode` to note the latents: `EgoHmr` has no VAE. It notes
`EgoHmr.encode`'s output instead, and before the first batch calls the
system's `redraw` (`systems/egohmr.py`) on the built weights, then
`scale_spreads` with the RMS of the reference's prediction on a batch of its
own. The benchmark's `sample` span bounds `EgoHmr.sample`, which encodes
inside itself (so no `scene` span), and its `joints` span the rest of the
batch."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from portbench import counts_gcn
from portbench.reference import plain
from portbench.routes import Route, Spans
from portbench.systems import Built, egohmr, generator
from portbench.traffic import Traffic

CALIBRATION = -2    # the index of the batch that scales the rot6d spreads


class EgoHmrCrops(Route):
    compared = ("feats", "pose", "joints", "vertices")

    def __init__(self, built: Built, traffic: Traffic, conf: Dict, ref_module):
        from seeme_tpu_torch.eval.hmr_metrics import HmrMetrics
        from seeme_tpu_torch.test_egohmr import evaluate_batch

        self.built, self.traffic, self.conf, self.refm = built, traffic, conf, ref_module
        self.system = built.system
        self.model = conf["config"]["model"]
        self.batch = traffic.batch_size
        self.steps = len(ref_module.schedule(conf)[0])
        egohmr.redraw(built, traffic.seed)
        egohmr.scale_spreads(built, self.reference_pose(CALIBRATION).pow(2).mean().sqrt())
        self.evaluate_batch, self.metrics = evaluate_batch, HmrMetrics()
        self._feats = None
        self._spans, self._rest = Spans(False), None
        encode, sample = self.system.encode, self.system.sample

        def noted(batch):
            enc = encode(batch)
            self._feats = torch.cat([enc["img"], enc["rest"]], dim=-1)
            return enc

        def spanned(*args, **kwargs):
            with self._spans("sample"):
                out = sample(*args, **kwargs)
            self._rest.enter_context(self._spans("joints"))
            return out

        self.system.encode, self.system.sample = noted, spanned

    def reference_pose(self, i: int) -> torch.Tensor:
        """The reference's final prediction on batch i, with batch i's draws."""
        inp, ar = self.prepare(i), plain.Arith()
        feats = self.refm.encode(ar, self.built.weights, self.conf, inp["batch"])
        return self.refm.sample(ar, self.built.weights, self.conf, inp["batch"], feats,
                                self.draws(inp))

    def prepare(self, i: int) -> Dict:
        return {"batch": self.traffic.batch(i), "index": i}

    def draws(self, inp: Dict) -> List[torch.Tensor]:
        """The batch's initial state and each noised step's draw, from the
        generator the program draws from (shapes alone on the meta device)."""
        dev = inp["batch"]["img"].device
        shape = (inp["batch"]["img"].shape[0], 144)
        if dev.type == "meta":
            return [torch.empty(shape, device=dev)] * self.steps
        g = generator(self.traffic.seed, "noise", dev, inp["index"])
        return [torch.randn(shape, generator=g, device=dev) for _ in range(self.steps)]

    def run(self, inp: Dict, spans: Spans) -> Dict:
        g = generator(self.traffic.seed, "noise", inp["batch"]["img"].device, inp["index"])
        self._spans = spans
        with contextlib.ExitStack() as self._rest:
            out = self.evaluate_batch(self.system, inp["batch"], g, self.metrics, self.batch)
        return {"feats": self._feats, "pose": out["pred_x_start"],
                "joints": out["pred_keypoints_3d"][:, :24], "vertices": out["pred_vertices"]}

    def program(self, out: Dict) -> Dict[str, torch.Tensor]:
        return out

    def reference(self, ar: plain.Arith, inp: Dict) -> Dict[str, torch.Tensor]:
        b, r, batch = self.built, self.refm, inp["batch"]
        feats = r.encode(ar, b.weights, self.conf, batch)
        pose = r.sample(ar, b.weights, self.conf, batch, feats, self.draws(inp))
        joints, vertices = r.mesh(ar, b.weights, b.body, b.mean, b.std, feats, pose)
        return {"feats": feats, "pose": pose, "joints": joints, "vertices": vertices}

    def shapes(self) -> Dict:
        m, w = self.model, self.built.weights
        return {"batch": self.batch, "steps": self.steps,
                "points": int(m["scene_points"]), "hidden": int(self.conf["pointnet_hidden"]),
                "gcn_shapes": counts_gcn.gcn_shapes(w), "gcn_numels": counts_gcn.gcn_numels(w),
                "cond_width": int(m["img_feat_dim"]) + int(m["scene_feat_dim"])
                + int(m["transl_embed_dim"]) + int(m["with_focal_length"])
                + 3 * int(m["with_bbox_info"]) + 2 * int(m["with_cam_center"])}


ROUTE = EgoHmrCrops
