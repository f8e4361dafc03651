"""precompute_ms: milliseconds a batch of the reverse process's per-window
precompute (the DDIM schedule's copies, the condition projection, the time
tokens, the MD stack's step invariants and their stacks): the program's own
`sample.precompute` spans (`ops/denoiser_fused.py`, recorded by
`seeme_tpu_torch/utils/profiling.py`), their CUDA-event milliseconds summed
over the traced window, over the window's batches. Nothing where the program
records no such span."""


def read(r):
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without spans
        return None
    span = summary()["spans"].get("sample.precompute")
    if not span or r.batches == 0:
        return None
    return span["device_ms"] / r.batches
