"""Model FLOP share of the card's peak in the untraced window: the
model's operations on the real rows' valid frames (training: forward and
twice that for the backward; no recomputation) over the window's wall time
times the peak of the cell's precision (bf16 989, float32 at the TF32 rate
495 TFLOP/s)."""


def read(r):
    if r.kind != "train" or r.window_s <= 0:
        return None
    return 100.0 * r.flops / (r.window_s * r.peak_flops)
