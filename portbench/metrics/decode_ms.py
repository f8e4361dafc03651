"""decode_ms: milliseconds a batch of the VAE decode of the sampled latents:
the program's own `sample.decode` spans (`SeeMeSystem.sample_from_cond`,
`T2MSystem.sample`, recorded by `seeme_tpu_torch/utils/profiling.py`), their
CUDA-event milliseconds summed over the traced window, over the window's
batches. Nothing where the program records no such span."""


def read(r):
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without spans
        return None
    span = summary()["spans"].get("sample.decode")
    if not span or r.batches == 0:
        return None
    return span["device_ms"] / r.batches
