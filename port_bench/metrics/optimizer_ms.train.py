"""Device milliseconds per training step of the kernels launched inside the
spans around the trainer's ``clip_by_global_norm``, the optimizer's
``step`` and ``update_ema`` (the flow model's EMA), in the traced round."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace_steps == 0 or r.trace.n_device == 0:
        return None
    return 1e3 * r.trace.span_s.get("bench.optimizer", 0.0) / r.trace_steps
