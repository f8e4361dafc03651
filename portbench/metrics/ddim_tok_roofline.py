"""ddim_tok_roofline: kernel 5 (`csrc/ddim_tok_t1.cu`, `ddim_tok_kernel`)
against its bound, in percent: each launch's least time (the larger of its
operations at 989 TFLOP/s and its bytes at 3.35 TB/s, from the denoiser's
weight shapes and the cell's rows, condition tokens and steps) summed over
the trace's launches, over their summed device time. Nothing where the trace
holds no launch."""

from portbench import counts, counts_tok


def read(r):
    s = r.shapes
    if r.trace is None:
        return None
    n, t = r.trace.kernel("ddim_tok_kernel")
    if n == 0 or t <= 0:
        return None
    flops = counts_tok.ddim_tok_flops(s["denoiser_shapes"], s["layers"], s["cond_rows"],
                                      s["n_cond"], s["steps"], s["tokens"])
    nbytes = counts.ddim_bytes(s["denoiser_numels"], s["cond_rows"], s["n_cond"], s["batch"],
                               s["tokens"], s["width"], s["steps"])
    return 100.0 * n * counts.bound_s(flops, nbytes) / t
