"""denoise_ms: milliseconds a batch of the reverse process itself (the DDIM
kernel's launch, or the whole `ddim_sample` loop over the eager denoiser):
the program's own `sample.denoise` spans (`ops/denoiser_fused.py`,
`diffusion/sampling.py`, recorded by `seeme_tpu_torch/utils/profiling.py`),
their CUDA-event milliseconds summed over the traced window, over the
window's batches. Nothing where the program records no such span."""


def read(r):
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without spans
        return None
    span = summary()["spans"].get("sample.denoise")
    if not span or r.batches == 0:
        return None
    return span["device_ms"] / r.batches
