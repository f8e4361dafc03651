"""Ego evaluation metrics (`seeme_tpu/eval/metrics.py:38-166`).

Per-sequence MPJPE, root error, head-orientation error and acceleration
error, with the reference's start alignment (head joint at frame 0) and
per-frame pelvis alignment, and the test-split filter that keeps a sequence
only when head_err < 0.9, root_err < 300 and accl > 0 (`compute.py:489-517`).
`EgoMetric` accumulates them over batches on the host, as the JAX package's
does; `compute(sync=True)` sums the accumulators over the ranks of a
data-parallel evaluation first (`parallel/mesh.py::allreduce_metric_sums`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..core.rotations import quat_to_rotmat
from ..parallel.mesh import allreduce_metric_sums
from ..utils.profiling import count, span

HEAD_JOINT = 15
PELVIS = 0
# the filtered means' keys, which every rank pre-seeds before a sync
FILTERED_KEYS = ("MPJPE", "ROOT_ERROR", "HEAD_ORIENTATION_ERROR", "ACCL")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim) -> torch.Tensor:
    mask = mask.to(x.dtype)
    return (x * mask).sum(dim) / mask.sum(dim).clamp_min(1.0)


def ego_sequence_metrics(jts_pred: torch.Tensor, jts_gt: torch.Tensor,
                         quat_pred: torch.Tensor, quat_gt: torch.Tensor,
                         mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, T, 24, 3) joints, (B, T, 4) wxyz orientations, (B, T) valid-frame
    mask -> per-sequence values, each (B,)."""
    jts_gt = jts_gt - jts_gt[:, 0:1, HEAD_JOINT:HEAD_JOINT + 1]
    jts_pred = jts_pred - jts_pred[:, 0:1, HEAD_JOINT:HEAD_JOINT + 1]
    pelvis_gt = jts_gt[:, :, PELVIS]
    pelvis_pred = jts_pred[:, :, PELVIS]
    jts_gt_a = jts_gt - jts_gt[:, :, PELVIS:PELVIS + 1]
    jts_pred_a = jts_pred - jts_pred[:, :, PELVIS:PELVIS + 1]

    err = torch.linalg.norm(jts_pred_a - jts_gt_a, dim=-1)
    mpjpe = _masked_mean(err.mean(-1), mask, 1) * 1000.0
    root_err = _masked_mean(torch.linalg.norm(pelvis_gt - pelvis_pred, dim=-1), mask, 1) * 1000.0

    R_gt = quat_to_rotmat(quat_gt)
    R_pred = quat_to_rotmat(quat_pred)
    eye = torch.eye(3, dtype=R_gt.dtype, device=R_gt.device)
    frob = torch.linalg.norm(eye - torch.einsum("btij,btkj->btik", R_gt, R_pred), dim=(-2, -1))
    head_err = _masked_mean(frob, mask, 1)

    accel_gt = jts_gt[:, :-2] - 2 * jts_gt[:, 1:-1] + jts_gt[:, 2:]
    accel_pred = jts_pred[:, :-2] - 2 * jts_pred[:, 1:-1] + jts_pred[:, 2:]
    accel_normed = torch.linalg.norm(accel_pred - accel_gt, dim=-1).mean(-1)
    accel_mask = mask[:, :-2] & mask[:, 1:-1] & mask[:, 2:]
    accl = _masked_mean(accel_normed, accel_mask, 1) * 1000.0
    return {"mpjpe": mpjpe, "root_err": root_err, "head_err": head_err, "accl": accl}


def kept_by_test_split(per_seq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,) bool: the sequences the reference's test split counts."""
    return ((per_seq["head_err"] < 0.9) & (per_seq["root_err"] < 300.0)
            & (per_seq["accl"] > 0.0))


def filtered_means(per_seq: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """MPJPE / ROOT_ERROR / HEAD_ORIENTATION_ERROR / ACCL means over the kept
    sequences (the `EgoMetric` test-split accumulation for one batch), and
    how many were kept."""
    keep = kept_by_test_split(per_seq)
    n = int(keep.sum())
    names = {"mpjpe": "MPJPE", "root_err": "ROOT_ERROR",
             "head_err": "HEAD_ORIENTATION_ERROR", "accl": "ACCL"}
    out = {names[k]: (float(v[keep].mean()) if n else float("nan")) for k, v in per_seq.items()}
    out["kept"] = n
    return out


def interactee_mpjpe(jts_int: torch.Tensor, jts_int_gt: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """(B,) root-aligned MPJPE of the other actor's joints, mm
    (`compute.py:476-481`)."""
    a = jts_int - jts_int[:, :, PELVIS:PELVIS + 1]
    b = jts_int_gt - jts_int_gt[:, :, PELVIS:PELVIS + 1]
    return _masked_mean(torch.linalg.norm(a - b, dim=-1).mean(-1), mask, 1) * 1000.0


@dataclass
class EgoMetric:
    """The reference's filtered-sum accumulator: on the test split a
    sequence counts only if `kept_by_test_split`; the interactee MPJPE,
    when given, always counts."""

    split: str = "test"
    sums: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    def _add(self, key: str, values) -> None:
        for v in values:
            self.sums[key] = self.sums.get(key, 0.0) + float(v)
            self.counts[key] = self.counts.get(key, 0) + 1

    @torch.no_grad()
    def update(self, jts_pred, jts_gt, quat_pred, quat_gt, mask,
               jts_int: Optional[torch.Tensor] = None,
               jts_int_gt: Optional[torch.Tensor] = None) -> None:
        """Add one batch's sequences; each boolean index and `.tolist()` is
        a read-back for which the host waits on the card."""
        with span("metric"):
            per_seq = ego_sequence_metrics(jts_pred, jts_gt, quat_pred, quat_gt, mask)
            if jts_int is not None and jts_int_gt is not None:
                count("host_sync.metric_tolist")
                self._add("mpjpe_interactee",
                          interactee_mpjpe(jts_int, jts_int_gt, mask).tolist())
            keep = (kept_by_test_split(per_seq) if self.split == "test"
                    else torch.ones_like(per_seq["mpjpe"], dtype=torch.bool))
            names = {"mpjpe": "MPJPE", "root_err": "ROOT_ERROR",
                     "head_err": "HEAD_ORIENTATION_ERROR", "accl": "ACCL"}
            for k, name in names.items():
                count("host_sync.metric_index")
                count("host_sync.metric_tolist")
                self._add(name, per_seq[k][keep].tolist())

    def compute(self, sync: bool = False) -> Dict[str, float]:
        """The mean of every key over the sequences counted so far; with
        `sync`, over every rank's (the (sum, count) pairs all-reduced first,
        the filtered keys pre-seeded so that a rank whose shard kept no
        sequence still aligns)."""
        sums, counts = self.sums, self.counts
        if sync:
            sums, counts = allreduce_metric_sums(sums, counts, FILTERED_KEYS)
        return {k: sums[k] / max(counts[k], 1) for k in sums}

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()
