"""The card's idle share of the traced round: 1 - the union of its device
operations' intervals over the round's wall time."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace_window_s <= 0 or r.trace.n_device == 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace_window_s)
