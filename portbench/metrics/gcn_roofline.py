"""gcn_roofline: EgoHMR's reverse process against its bound, in percent: the
least time of one batch's steps (the larger of their operations at 989
TFLOP/s and their bytes at 3.35 TB/s, `portbench/counts_gcn.py`, from the
weight shapes and the cell's batch and steps) over the program's own
`sample.denoise` spans (`models/egohmr.py::EgoHmr.sample`), their CUDA-event
milliseconds a batch. Nothing where the cell has no GCN or the program records
no such span."""

from portbench import counts, counts_gcn


def read(r):
    s = r.shapes
    if "gcn_shapes" not in s or r.batches == 0:
        return None
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without spans
        return None
    span = summary()["spans"].get("sample.denoise")
    if not span or span["device_ms"] <= 0:
        return None
    flops = counts_gcn.reverse_flops(s["gcn_shapes"], s["batch"], s["steps"])
    nbytes = counts_gcn.reverse_bytes(s["gcn_numels"], s["batch"], s["steps"], s["cond_width"])
    return 100.0 * counts.bound_s(flops, nbytes) / (span["device_ms"] / 1e3 / r.batches)
