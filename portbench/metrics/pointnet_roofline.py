"""pointnet_roofline: kernels 1 and 2 (`csrc/pointnet.cu`,
`input_block_kernel`, `split_block_kernel`) against their bound, in
percent: each launch's least time (the larger of its operations at 989
TFLOP/s and its bytes at 3.35 TB/s, from the cell's shapes) summed over the
trace's launches, over the launches' summed device time. Nothing where the
trace holds no launch."""

from portbench import counts


def read(r):
    s = r.shapes
    if r.trace is None or "points" not in s:
        return None
    B, N, H = s["batch"], s["points"], s["hidden"]
    n1, t1 = r.trace.kernel("input_block_kernel")
    n2, t2 = r.trace.kernel("split_block_kernel")
    if n1 + n2 == 0 or t1 + t2 <= 0:
        return None
    bound = (n1 * counts.bound_s(counts.input_block_flops(B, N, H),
                                 counts.input_block_bytes(B, N, H))
             + n2 * counts.bound_s(counts.split_block_flops(B, N, H),
                                   counts.split_block_bytes(B, N, H)))
    return 100.0 * bound / (t1 + t2)
