"""host_syncs: the program's blocking reads and copies a batch, where the host
waits for the card's stream (`host_sync.<site>` counters of
`seeme_tpu_torch/utils/profiling.py`), summed over every site and the traced
window, over the window's batches. Nothing where the program counts none."""


def read(r):
    try:
        from seeme_tpu_torch.utils.profiling import summary
    except ImportError:     # a port without counters
        return None
    counts = [n for name, n in summary()["counters"].items() if name.startswith("host_sync.")]
    if not counts or r.batches == 0:
        return None
    return sum(counts) / r.batches
