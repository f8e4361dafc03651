"""sample_ms: milliseconds a batch of the reverse process and the decode
(`SeeMeSystem.sample_from_cond` or `T2MSystem.sample`: kernel 3 or 5, the
VAE decode), by CUDA events around the call; the mean over the traced
window's batches."""


def read(r):
    ms = r.spans_ms.get("sample")
    return sum(ms) / len(ms) if ms else None
