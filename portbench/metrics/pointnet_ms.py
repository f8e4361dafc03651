"""pointnet_ms: milliseconds a batch of the PointNet scene encode (kernels 1
and 2, with the check of their kernel-layout weights): the program's own
`encode.pointnet` spans (`SeeMeSystem.scene_features`, recorded by
`seeme_tpu_torch/utils/profiling.py`), their CUDA-event milliseconds summed
over the traced window, over the window's batches. Nothing where the program
records no such span."""


def read(r):
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without spans
        return None
    span = summary()["spans"].get("encode.pointnet")
    if not span or r.batches == 0:
        return None
    return span["device_ms"] / r.batches
