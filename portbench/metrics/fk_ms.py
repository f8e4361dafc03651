"""fk_ms: milliseconds a batch of the joints' recovery (each `smpl_joints24`
chain, or the RIC recovery): the program's own `joints.fk` spans
(`core/smpl.py`, `data/humanml.py::feats2joints`, recorded by
`seeme_tpu_torch/utils/profiling.py`), their CUDA-event milliseconds summed
over the traced window, over the window's batches. Nothing where the program
records no such span."""


def read(r):
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without spans
        return None
    span = summary()["spans"].get("joints.fk")
    if not span or r.batches == 0:
        return None
    return span["device_ms"] / r.batches
