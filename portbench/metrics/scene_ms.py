"""scene_ms: milliseconds a batch of the scene and condition encode
(`SeeMeSystem.encode_conditioning`: the interactee's VAE encode and the
PointNet through kernels 1 and 2), by CUDA events around the call; the mean
over the traced window's batches. Nothing where the window encodes none."""


def read(r):
    ms = r.spans_ms.get("scene")
    return sum(ms) / len(ms) if ms else None
