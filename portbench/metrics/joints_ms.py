"""joints_ms: milliseconds a batch of the joints and the metric
(`SeeMeSystem.eval_fk` and `EgoMetric.update`, or `T2MSystem.feats_to_joints`
and the per-sequence MPJPE), up to the metric's read-back, by CUDA events
around them; the mean over the traced window's batches."""


def read(r):
    ms = r.spans_ms.get("joints")
    return sum(ms) / len(ms) if ms else None
