"""image_ms: milliseconds a batch of the image encode (the ResNet50 over the
batch's crops): the program's own `encode.image` spans
(`models/egohmr.py::EgoHmr.encode`, recorded by
`seeme_tpu_torch/utils/profiling.py`), their CUDA-event milliseconds summed
over the traced window, over the window's batches. Nothing where the program
records no such span."""


def read(r):
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without spans
        return None
    span = summary()["spans"].get("encode.image")
    if not span or r.batches == 0:
        return None
    return span["device_ms"] / r.batches
