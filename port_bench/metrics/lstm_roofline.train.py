"""The LSTM op's share of its roofline in the traced round: the least time
of its work (the input and recurrent products of every BLSTM call, valid
steps of real rows only, forward; in training also the backward's dx, dh,
dW_ih and dW_hh) over the device time of every kernel the op launched (in
the spans around ``ops.lstm``'s functions, and in the backward nodes of
the autograd ops recorded there)."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace.span_s.get("bench.lstm", 0.0) <= 0:
        return None
    return 100.0 * r.trace_lstm_least_s / r.trace.span_s["bench.lstm"]
