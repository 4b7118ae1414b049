"""The LSTM op's device time (as ``lstm_roofline`` counts it) over all
device time in the traced round."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace.device_s <= 0:
        return None
    return 100.0 * r.trace.span_s.get("bench.lstm", 0.0) / r.trace.device_s
