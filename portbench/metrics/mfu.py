"""mfu: the whole batch path's share of the card's bf16 dense peak, in
percent: the operations of one batch (FlopCounterMode over the plain
reference of what the window runs, on the meta device), times the traced
window's batches, over the traced window's seconds and 989 TFLOP/s."""

from portbench import counts


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0 or not r.batch_flops:
        return None
    return 100.0 * r.batch_flops * r.batches / t.window_s / counts.PEAK_FLOPS
