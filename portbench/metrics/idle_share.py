"""idle_share: the percentage of the traced window in which no operation
ran on the card (the union of the trace's device intervals against the
`bench.window` range)."""


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
